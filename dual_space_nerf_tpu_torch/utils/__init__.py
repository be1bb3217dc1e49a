from .image_io import write_png
from .logger import make_summary_writer, setup_logger
from .mesh_extract import marching_tetrahedra, save_obj

__all__ = ["make_summary_writer", "marching_tetrahedra", "save_obj", "setup_logger", "write_png"]
