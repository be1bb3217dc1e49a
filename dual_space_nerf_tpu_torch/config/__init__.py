from .defaults import get_cfg_defaults
from .node import CfgNode, ConfigSyntaxError, dump_config_text, parse_config_text

__all__ = ["CfgNode", "ConfigSyntaxError", "dump_config_text", "get_cfg_defaults", "parse_config_text"]
