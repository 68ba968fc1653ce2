from . import dist
from .device import compute_dtype, resolve_device
from .logger import create_logger, log_config

__all__ = ["compute_dtype", "create_logger", "dist", "log_config", "resolve_device"]
