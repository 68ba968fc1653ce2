"""Hand-written CUDA kernels of the port and their plain versions."""

from . import attention, fused_mlp
from ._build import BUILD_DIR, build_all

KERNELS = (attention.KERNEL, fused_mlp.KERNEL)

__all__ = ["BUILD_DIR", "KERNELS", "attention", "build_all", "fused_mlp"]
