"""IO (counterpart of ``mmlspark_tpu/io/``): binary and image file
ingestion, HTTP-on-DataFrame (:mod:`.http`), the websocket transport
(:mod:`.ws`) and the PowerBI sink."""

from .binary import list_binary_files, read_binary_files
from .image_io import read_images
from .powerbi import PowerBIWriter, write_to_powerbi

__all__ = ["list_binary_files", "read_binary_files", "read_images",
           "PowerBIWriter", "write_to_powerbi"]
