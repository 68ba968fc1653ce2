"""Matmul FLOP accounting of a run, and the card's published peaks.

Counterpart of ``pevit_tpu/utils/flops.py``, which sums 2*M*N*K over the
``dot_general``s of a traced jaxpr.  Here :func:`step_flops` runs the
function under ``torch.utils.flop_counter.FlopCounterMode``, which counts
every matrix product and convolution that PyTorch dispatches, and each of
the port's operators (``ops``) by its registered formula: the products of
the reference's plain path, not a kernel's recompute.  Run the function on
fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``) to count a
full-size step without computing it.  The result is the numerator of a
model FLOP utilisation share.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from torch.utils.flop_counter import FlopCounterMode

from .. import ops as _ops  # noqa: F401  (registers the operators' FLOP formulas)


def step_flops(fn, *args) -> int:
    """Run ``fn(*args)`` and return the FLOPs of its matrix products
    (2 per multiply-add), the port's operators counted by their formulas."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())


class Peaks(NamedTuple):
    """A card's published rates: device memory GB/s and dense TFLOP/s.
    ``fp32_tflops`` is float32 on the FMA units; ``tf32_tflops`` is TF32 on
    the tensor cores, which a float32 product split in three TF32 products
    (the kernels' float32 bodies) runs at a third of."""

    hbm_gb_s: Optional[float]
    bf16_tflops: Optional[float]
    fp32_tflops: Optional[float]
    tf32_tflops: Optional[float]


# by a substring of torch.cuda.get_device_name(); NVIDIA's data sheet, H100
# SXM (whose name is "NVIDIA H100 80GB HBM3"), dense, at its 700 W limit:
# 3.35 TB/s, 989 TFLOP/s bf16 and 495 TF32 on the tensor cores, 67 TFLOP/s
# fp32 outside them
CHIP_SPECS = {
    "h100 80gb hbm3": Peaks(3350.0, 989.0, 67.0, 495.0),
}


def chip_peaks(kind: str) -> Peaks:
    """The peaks of the card named ``kind``; all None for a card the table
    does not hold."""
    k = kind.lower()
    for sub, peaks in CHIP_SPECS.items():
        if sub in k:
            return peaks
    return Peaks(None, None, None, None)
