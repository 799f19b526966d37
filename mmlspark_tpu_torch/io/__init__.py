"""IO (counterpart of ``mmlspark_tpu/io/``): binary and image file
ingestion; the HTTP schema lives in :mod:`.http`."""

from .binary import list_binary_files, read_binary_files
from .image_io import read_images

__all__ = ["list_binary_files", "read_binary_files", "read_images"]
