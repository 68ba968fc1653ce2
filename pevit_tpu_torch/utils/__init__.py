from .device import compute_dtype, resolve_device

__all__ = ["compute_dtype", "resolve_device"]
