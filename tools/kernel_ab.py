"""K1 (attention) of this checkout against the same kernel built from another
checkout's sources, timed in turns on one CUDA card.

    python3 tools/kernel_ab.py OTHER_CSRC

``OTHER_CSRC`` is another checkout's ``pevit_tpu_torch/ops/csrc`` (unpack it
with ``git archive``).  Its C entries may lack the arguments this
checkout's take (``attention_fwd``'s hd, the fused MLP's LayerNorm count):
then the other version runs at the shapes both take, head width 64 and
the model widths 768 and 1024, where those arguments are the defaults.
Every source is built by ``nvcc``; at ViT-B's serving and training shapes
(batch 256 and N = 50, 197, 257 in bf16 and 64 images, N = 197, in fp32)
each version is held against the plain version and timed through this
checkout's wrappers in turns, other, this, this, other (median CUDA-event
ms of each turn, the mean of a version's two).  One JSON line a shape; the
card's name and power limit first.  It needs a CUDA card and exits
non-zero without one, or if a version disagrees with the plain version.
K2 and K3 (the fused MLP) have their own A/B, ``tools/fused_mlp_ab.py``,
which builds the other version with :func:`other_kernels` and swaps it in
with :func:`launching`.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the C entry's argument that an older source lacks: (its index, the text
# that marks a source taking it)
NEW_ARGS = {"attention_fwd": (8, "int N, int hd,"), "fused_mlp_fwd": (13, "int CL,"),
            "fused_mlp_bwd": (13, "int CL,")}


class Legacy:
    """A kernel whose C entry lacks one argument of this checkout's: the
    wrapper's launch drops it."""

    def __init__(self, kernel, drop: int):
        self.kernel, self.drop = kernel, drop

    def launch(self, *args):
        self.kernel.launch(*args[:self.drop], *args[self.drop + 1:])


def other_kernels(csrc: Path) -> dict:
    """{name: a kernel (or its Legacy shim)} built from ``csrc``'s sources."""
    from pevit_tpu_torch.ops import KERNELS
    from pevit_tpu_torch.ops._build import Kernel, build_all

    out, built = {}, []
    for k in KERNELS:
        src = csrc / k.source.name
        drop, mark = NEW_ARGS[k.name]
        takes = mark in src.read_text()
        argtypes = k.argtypes if takes else k.argtypes[:drop] + k.argtypes[drop + 1:]
        other = Kernel(k.name, str(src.resolve()), argtypes, replaces=k.replaces)
        built.append(other)
        out[k.name] = other if takes else Legacy(other, drop)
    build_all(built)
    return out


@contextlib.contextmanager
def launching(name: str, kernel):
    """This checkout's wrapper of ``name`` with ``kernel`` in place of its own."""
    from pevit_tpu_torch.ops import attention, fused_mlp

    module, attr = {"attention_fwd": (attention, "KERNEL"),
                    "fused_mlp_fwd": (fused_mlp, "KERNEL"),
                    "fused_mlp_bwd": (fused_mlp, "BWD_KERNEL")}[name]
    saved = getattr(module, attr)
    setattr(module, attr, kernel)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def cases(gen):
    """(name, shape, dtype, run, plain) at the shapes both versions take."""
    import torch

    from pevit_tpu_torch.ops import attention as ta

    t = lambda x: x.transpose(1, 2)
    for dtype, shapes in ((torch.bfloat16, ((256, 50), (256, 197), (256, 257))),
                          (torch.float32, ((64, 197),))):
        for b, n in shapes:
            q, k, v = (torch.randn(b, n, 12, 64, device="cuda", generator=gen) * s
                       for s in (0.25, 0.25, 1.0))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            yield ("attention_fwd", f"B*H={b}*12 N={n} hd=64", dtype,
                   lambda q=q, k=k, v=v: ta.attention_fwd(q, k, v),
                   lambda q=q, k=k, v=v: t(ta.attention_ref(t(q), t(k), t(v))))


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pevit_tpu_torch.ops import KERNELS, build_all
    from pevit_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    print(cs.card_line(), flush=True)
    build_all(KERNELS)
    others = other_kernels(Path(argv[0]))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, dtype, run, plain in cases(gen):
        want = plain()
        tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
        with launching(name, others[name]):
            other_err = cs.check_close(f"{name} other", run(), want, *tol)
        this_err = cs.check_close(f"{name} this", run(), want, *tol)
        turns = {"other": [], "this": []}
        for version in ("other", "this", "this", "other"):
            with (launching(name, others[name]) if version == "other"
                  else contextlib.nullcontext()):
                turns[version].append(cs.time_ms(run, reps=10))
        print(json.dumps({"kernel": name, "shape": shape, "dtype": str(dtype).split(".")[-1],
                          "other_ms": statistics.mean(turns["other"]),
                          "this_ms": statistics.mean(turns["this"]), "turns_ms": turns,
                          "other_max_abs_err": other_err, "this_max_abs_err": this_err}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
