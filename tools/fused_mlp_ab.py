"""K2 and K3 (the fused MLP forward and backward kernels) of this checkout
against the same kernels built from another checkout's sources: their
outputs compared bit for bit, and their device time in turns, in bf16 and
in float32.

    python3 tools/fused_mlp_ab.py OTHER_CSRC [--shapes KIND:R:C:F ...] [--launches]
        [--time-only] [--out FILE]

``OTHER_CSRC`` is another checkout's ``pevit_tpu_torch/ops/csrc`` (unpack
it with ``git archive``) whose C entries take the LayerNorm's count CL, as
this checkout's do.  Every source is built by ``nvcc`` (ptxas registers and
spills of this checkout's GEMM kernels printed); at each row of ``SHAPES``
(K2 at ViT-B's serving and training rows, K3 at its training rows, both at
the ragged rows training hits, at C = 1024 and 1280 and at widths that fill
no tile or no 16-byte row) each version runs through this checkout's
wrapper on the same seeded inputs, is held against the plain version
(2e-2 in bf16; in float32 1e-4 and ``chip_smoke.fp32_class`` against a
float64 run, its readings under ``this_fp32`` and ``other_fp32``), and the
two outputs are compared element by element (``bit_equal``,
``share_differing``, ``max_abs_diff``: reported, not required); then each is timed
in turns, other, this, this, other (``device_ms``: the median device time
of a call replayed from a CUDA graph, so the host's issue stays out; the
mean of a version's two turns), beside one call's CUDA-event time of each
and ``gemm_ms``, the kernel's products as ``torch.matmul`` calls in device
time (a yardstick the port never calls).  ``--shapes`` runs only the given
rows (``fwd:12800:768:3072``); ``--launches`` adds each version's device
ms a call by kernel (a CUDA-only profile of 10 calls), which splits a
call into its launches.  ``--time-only`` skips the comparisons, for an
OTHER_CSRC that is a probe computing something else (a copy of this
tree's sources with a part left out, timed to see what that part costs).
One JSON line a row, the card's name and power
limit first.  It needs a CUDA card and exits non-zero
without one, or if a version disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# (kernel, R, C, F): K2 at R = 12800 and 6400 (ViT-B/32 batches 256 and
# 128), K3 at 6400, both at 5800 and 400 (phase 5's tail and eval
# remainder), at ViT-L/14's C = 1024 (R = 32 x 577) and ViT-H/14's C =
# 1280 (R = 32 x 257), at (200, 800) (no whole tile) and (100, 300) (no
# whole 16-byte row: the wrapper zero-pads it); "fwdx" and "bwdx" with every
# fourth hidden unit's bias from -53.5 to -49.5, so that its pre-activations
# reach the range where the sigmoid's reciprocal leaves the fast path
# (below about -51.3: 1 / x subnormal, then 0).  A kind ending in "32" is
# the float32 body's row: K2 at ViT-B/32's serving batch and the fp32
# artifacts' batches 1 and 8 (R = 50, 400), K3 at its training batch, both
# at C = 1280 and at a width the wrapper zero-pads, and with the extreme
# biases
SHAPES = (("fwd", 12800, 768, 3072), ("fwd", 6400, 768, 3072), ("bwd", 6400, 768, 3072),
          ("fwdx", 6400, 768, 3072), ("bwdx", 6400, 768, 3072),
          ("fwd", 5800, 768, 3072), ("bwd", 5800, 768, 3072), ("fwd", 400, 768, 3072),
          ("bwd", 400, 768, 3072), ("fwd", 18464, 1024, 4096), ("bwd", 18464, 1024, 4096),
          ("fwd", 8224, 1280, 5120), ("bwd", 8224, 1280, 5120), ("fwd", 8224, 200, 800),
          ("bwd", 8224, 200, 800), ("fwd", 8224, 100, 300), ("bwd", 8224, 100, 300),
          ("fwd32", 12800, 768, 3072), ("bwd32", 6400, 768, 3072), ("fwd32", 50, 768, 3072),
          ("fwd32", 400, 768, 3072), ("bwd32", 400, 768, 3072), ("fwd32", 8224, 1280, 5120),
          ("bwd32", 8224, 1280, 5120), ("fwd32", 8224, 100, 300), ("bwd32", 8224, 100, 300),
          ("fwdx32", 6400, 768, 3072), ("bwdx32", 6400, 768, 3072))


def inputs(gen, R: int, C: int, F: int, extreme: bool = False, dtype=None) -> dict:
    """x, dy and weights in ``dtype`` (bf16 unless given), float32 LayerNorm
    scale and bias, seeded; ``extreme``: every fourth hidden unit's bias
    from -53.5 to -49.5."""
    import torch

    dt = dtype or torch.bfloat16
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    t = {"x": r(R, C).to(dt), "dy": r(R, C).to(dt), "ln_s": 1 + 0.1 * r(C),
         "ln_b": 0.1 * r(C), "wfc": (r(C, F) * C ** -0.5).to(dt),
         "bfc": (0.1 * r(F)).to(dt), "wproj": (r(F, C) * F ** -0.5).to(dt),
         "bproj": (0.1 * r(C)).to(dt)}
    if extreme:
        t["bfc"][::4] = torch.linspace(-53.5, -49.5, t["bfc"][::4].numel(), device="cuda")
    return t


def calls(kind: str, t: dict) -> tuple:
    """(kernel name, the kernel call, its plain version, its products as
    torch.matmul calls, its float64 plain version)."""
    import torch

    import chip_smoke as cs
    from pevit_tpu_torch.ops import fused_mlp as tf

    dt = t["x"].dtype
    if kind.startswith("fwd"):
        args = (t["x"], t["ln_s"], t["ln_b"], t["wfc"], t["bfc"], t["wproj"], t["bproj"])
        u = torch.randn_like(t["x"], dtype=torch.float32).to(dt)
        g = torch.randn(t["x"].shape[0], t["wfc"].shape[1], device="cuda").to(dt)
        return ("fused_mlp_fwd", lambda: tf.fused_mlp_fwd(*args),
                lambda: tf.fused_mlp_residual_ref(*args), lambda: (u @ t["wfc"], g @ t["wproj"]),
                lambda: cs.fused_mlp_f64(*args))
    args = (t["dy"], t["x"], t["ln_s"], t["ln_b"], t["wfc"], t["bfc"], t["wproj"])
    u = torch.randn_like(t["x"], dtype=torch.float32).to(dt)
    dh = torch.randn(t["x"].shape[0], t["wfc"].shape[1], device="cuda").to(dt)
    return ("fused_mlp_bwd", lambda: tf.fused_mlp_bwd(*args), lambda: tf.fused_mlp_bwd_ref(*args),
            lambda: (u @ t["wfc"], t["dy"] @ t["wproj"].T, dh @ t["wfc"].T),
            lambda: cs.fused_mlp_bwd_f64(*args))


def by_kernel(fn, calls: int = 10) -> dict:
    """{kernel name: device ms a call of fn} from a CUDA-only profile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = re.sub(r"\(anonymous namespace\)::|^void ", "", e.name()).split("(")[0]
            out[name] = out.get(name, 0.0) + (e.end_ns() - e.start_ns()) / 1e6 / calls
    return out


def run_row(others: dict, kind: str, R: int, C: int, F: int, gen, launches: bool = False,
            check: bool = True) -> dict:
    import torch

    import chip_smoke as cs
    from kernel_ab import launching
    from pevit_tpu_torch.tools.attention_bodies import device_ms

    f32 = kind.endswith("32")
    dtype = torch.float32 if f32 else torch.bfloat16
    tol = 1e-4 if f32 else 2e-2
    name, run, plain, gemms, plain64 = calls(
        kind, inputs(gen, R, C, F, kind.removesuffix("32").endswith("x"), dtype))
    want = plain()
    with launching(name, others[name]):
        old = run()
    new = run()
    torch.cuda.synchronize()
    row = {"kernel": name, "kind": kind, "R": R, "C": C, "F": F, "dtype": str(dtype)[6:],
           "this_max_abs_err": cs.check_close(f"{name} this", new, want, tol, tol)}
    if f32:
        row["this_fp32"] = cs.fp32_class(f"{name} this", new, plain, plain64)
    if check:
        row["other_max_abs_err"] = cs.check_close(f"{name} other", old, want, tol, tol)
        if f32:
            row["other_fp32"] = cs.fp32_class(f"{name} other", old, plain, plain64)
        diff = (new.float() - old.float()).abs()
        bits = lambda out: out.contiguous().view(torch.int32 if f32 else torch.int16)
        row.update({"bit_equal": bool(torch.equal(bits(new), bits(old))),
                    "share_differing": (diff > 0).float().mean().item(),
                    "max_abs_diff": diff.max().item()})
    turns = {"other": [], "this": []}
    for version in ("other", "this", "this", "other"):
        with launching(name, others[name]) if version == "other" else contextlib.nullcontext():
            turns[version].append(device_ms(run))
    with launching(name, others[name]):
        other_call = cs.time_ms(run)
    this_ms, other_ms = statistics.mean(turns["this"]), statistics.mean(turns["other"])
    row.update({"this_ms": this_ms, "other_ms": other_ms, "this_over_other": this_ms / other_ms,
                "turns_ms": turns, "this_call_ms": cs.time_ms(run), "other_call_ms": other_call,
                "gemm_ms": device_ms(gemms)})
    row["this_over_gemm"] = this_ms / row["gemm_ms"]
    if launches:
        with launching(name, others[name]):
            row["other_by_kernel"] = by_kernel(run)
        row["this_by_kernel"] = by_kernel(run)
    return row


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("fused_mlp_ab: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other_csrc", type=Path)
    parser.add_argument("--shapes", nargs="+", default=None, help="rows as KIND:R:C:F")
    parser.add_argument("--launches", action="store_true", help="split each call by kernel")
    parser.add_argument("--time-only", action="store_true", help="OTHER_CSRC is a probe")
    parser.add_argument("--out", type=Path, default=None, help="also write the lines here")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO / "tools"))
    import chip_smoke as cs
    from kernel_ab import other_kernels
    from pevit_tpu_torch.ops import KERNELS, build_all
    from pevit_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    lines = [cs.card_line()]
    print(lines[0], flush=True)
    for name, log in build_all(KERNELS).items():
        for line in cs.ptxas_summary(name, log):
            if "gemm_" in line:
                print(line, flush=True)
        for line in log.splitlines():  # e.g. ptxas serializing wgmma
            if "arning" in line or "erializ" in line:
                print(f"nvcc {name}: {line.strip()}", flush=True)
    others = other_kernels(args.other_csrc)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = SHAPES if args.shapes is None else [
        (kind, *map(int, rest)) for kind, *rest in (s.split(":") for s in args.shapes)]
    for kind, R, C, F in shapes:
        line = json.dumps(run_row(others, kind, R, C, F, gen, args.launches,
                                  not args.time_only))
        lines.append(line)
        print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
