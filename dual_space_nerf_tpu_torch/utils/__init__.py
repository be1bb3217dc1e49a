from .image_io import write_png
from .logger import make_summary_writer, setup_logger

__all__ = ["make_summary_writer", "setup_logger", "write_png"]
