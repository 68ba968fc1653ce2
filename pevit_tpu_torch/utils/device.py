"""Device selection for the port's entry points.

The port runs on CUDA.  The CPU is used only when a caller asks for it by
name (the tests do); no entry point picks it by itself when CUDA is absent.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises if CUDA is absent); anything else as given.

    On a CUDA device both TF32 switches are set off, so float32 matrix
    products and convolutions run in full float32, as the reference's parity
    mode does: ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU explicitly"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def to_numpy(x) -> np.ndarray:
    """A numpy copy of an array, or of a tensor on any device."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def compute_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` | ``"float32"`` -> the torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"compute dtype must be one of {sorted(_DTYPES)}, got {name!r}") from None
