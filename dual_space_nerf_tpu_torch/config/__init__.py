from .defaults import get_cfg_defaults
from .node import CfgNode

__all__ = ["CfgNode", "get_cfg_defaults"]
