"""K1 (the attention kernel) against other versions of its source, timed in
turns on one CUDA card.

    python -m pevit_tpu_torch.tools.attention_bodies [--against LABEL=DIR ...]
        [--set LABEL:NAME=VALUE[,NAME=VALUE] ...] [--lengths N [N ...]]
        [--dtype bfloat16|float32] [--out FILE]

Each ``DIR`` holds another ``attention_fwd.cu`` with the same C interface
(hd an argument; with its ``*.cuh`` headers beside it), e.g. the ``csrc`` directory of an
earlier commit unpacked by ``git archive``.  Each ``--set`` builds a copy of
this tree's source with ``constexpr`` constants set otherwise (e.g.
``smem:TMA_MAX_SEQ=0`` sends bf16 N <= 257 to the shared-memory body,
``three:CONSUMERS=3`` gives the persistent body three consumer warpgroups),
a design choice timed against the source as it is.  Every source is built by
``nvcc`` (ptxas registers and spills printed), then, in bfloat16 at each
(N, head width, heads, batch) of ``SHAPES`` (those of the given
``--lengths`` only, where given; logits of std 0.5 at every width), each
version is held against the plain version
(``attention_ref``, within 2e-2) and timed
through the wrapper ``attention_fwd`` in turns, the others, this, this, the
others in reverse (``device_ms``: the median device time of a call
replayed from a CUDA graph, so that the host's time to issue it stays out;
the mean of a version's two turns), beside ``scaled_dot_product_attention``
on contiguous copies, a yardstick the port never calls.  With ``--dtype
float32`` it runs the float32 bodies at ``F32_SHAPES`` instead (the fp32
serving artifacts' N = 50 at batches 1 to 256, a ViT-B/16 backbone's 64
images, ViT-L/14's 257 tokens at 256, MAE ViT-H/14's heads of 80), each
version held to the plain version at phase 3's float32 tolerance (rtol
1e-4, atol 1e-5), each row with its bound (the lower of the bytes-or-FMA
and the bytes-or-3xTF32 bounds, ``chip_smoke.bound_fields``' rule) and
each other version's share of outputs that differ from this one's.  A
version that refuses a shape (a launch error) is reported as refusing it.  One JSON line
a shape; the card's name and power limit first.  It needs a CUDA card and
exits non-zero without one, or if a version disagrees with the plain
version.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

# (N, hd, heads, batches): at hd 64 and 12 heads ViT-B/32 (N = 50) at the
# serving batch, the training batch and the batches the smoke's paths give
# it (eval remainders, trial-folded chunks), ViT-B/16 (197) and ViT-L/14
# (257) at 64 and 256, ViT-L/14 at 336 px (577) and 1025; the short ring's
# first N, CLIP ViT-H/14 at 378 px (730, 20 heads) at its served and
# trained batches, the short ring's last N and one more, and 1025, at 16
# heads; the wider heads 80, 128 and 256 at 16 heads, N = 197 and 577
SHAPES = ((50, 64, 12, (8, 32, 128, 256, 1280)), (197, 64, 12, (32, 64, 256)),
          (257, 64, 12, (32, 64, 256)), (577, 64, 12, (32, 64)), (1025, 64, 12, (8,)),
          (641, 64, 16, (16,)), (730, 64, 20, (8, 32, 64)), (768, 64, 16, (16,)),
          (769, 64, 16, (16,)), (1025, 64, 16, (8,)),
          *((n, hd, 16, (batch,)) for hd in (80, 128, 256) for n, batch in ((197, 64), (577, 32))))
# the float32 rows, (N, hd, heads, batches): N = 50 at the fp32 serving
# artifacts' batches 1 and 8, at 64, 128 and the zero-shot chunk of 256;
# ViT-B/16's 197 at a backbone's 64 images; 257 (ViT-L/14's tokens) at
# 256; MAE ViT-H/14 (heads of 80, 16 of them) at 64
F32_SHAPES = ((50, 64, 12, (1, 8, 64, 128, 256)), (197, 64, 12, (64,)), (257, 64, 12, (256,)),
              (257, 80, 16, (64,)))


def f32_bound_ms(batch: int, n: int, heads: int, hd: int) -> float:
    """The card's least time for a float32 call: the lower of the FMA
    units' bound and three TF32 products' on the tensor cores, each the
    larger of its operations' time and the bytes' (q, k, v read and the
    output written once)."""
    from pevit_tpu_torch.utils.flops import chip_peaks

    peaks = chip_peaks(torch.cuda.get_device_name(0))
    n_bytes, ops = 16 * batch * heads * n * hd, 4 * batch * heads * n * n * hd
    t_bytes = n_bytes / (peaks.hbm_gb_s * 1e9) * 1e3
    return min(max(t_bytes, 3 * ops / (peaks.tf32_tflops * 1e12) * 1e3),
               max(t_bytes, ops / (peaks.fp32_tflops * 1e12) * 1e3))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Median device ms of one call of ``fn``: ``calls`` calls captured in a
    CUDA graph and replayed between CUDA events after a warm-up, so that
    the host's time to issue a call (tens of microseconds through a
    wrapper) stays out of the card's."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    del graph
    return statistics.median(times)


def source_variant(tmp: Path, label: str, **consts):
    """K1 built from a copy of this tree's ``csrc`` in ``tmp / label`` with
    ``constexpr`` constants of ``attention_fwd.cu`` set otherwise (each set
    exactly once there); a measurement aid, never on a path."""
    from pevit_tpu_torch.ops import attention
    from pevit_tpu_torch.ops._build import CSRC, Kernel

    shutil.copytree(CSRC, tmp / label)
    src = tmp / label / "attention_fwd.cu"
    text = src.read_text()
    for name, value in consts.items():
        pattern = re.compile(rf"constexpr (int|bool) {name} = [^;]+;")
        if len(pattern.findall(text)) != 1:
            raise AssertionError(f"attention_fwd.cu no longer sets the constexpr {name} once")
        value = str(value).lower() if isinstance(value, bool) else str(value)
        text = pattern.sub(lambda m: f"constexpr {m.group(1)} {name} = {value};", text)
    src.write_text(text)
    return Kernel("attention_fwd", str(src), attention.KERNEL.argtypes,
                  replaces=attention.KERNEL.replaces)


@contextlib.contextmanager
def launching(kernel):
    """The wrapper ``attention_fwd`` with ``kernel``'s library in place of
    the package's, for the duration."""
    from pevit_tpu_torch.ops import attention

    saved = attention.KERNEL
    attention.KERNEL = kernel
    try:
        yield
    finally:
        attention.KERNEL = saved


def run_shape(versions: dict, n: int, hd: int, heads: int, batch: int, gen,
              dtype=torch.bfloat16) -> dict:
    from pevit_tpu_torch.ops._build import KernelLaunchError
    from pevit_tpu_torch.ops.attention import attention_fwd, attention_ref, launch_plan

    qk = (0.25 / hd) ** 0.25
    q, k, v = (torch.randn(batch, n, heads, hd, device="cuda", generator=gen) * s
               for s in (qk, qk, 1.0))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    t = lambda x: x.transpose(1, 2)
    want = t(attention_ref(t(q), t(k), t(v))).float()
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 2e-2)
    row = {"N": n, "hd": hd, "batch": batch, "heads": heads, "dtype": str(dtype).split(".")[-1],
           "this_body": launch_plan(batch, n, heads, hd, dtype).body}
    if dtype == torch.float32:
        row["bound_ms"] = f32_bound_ms(batch, n, heads, hd)
    takes, outs = {}, {}
    for name, kernel in versions.items():
        with launching(kernel):
            try:
                got = attention_fwd(q, k, v).float()
                torch.cuda.synchronize()
            except KernelLaunchError as e:
                row[f"{name}_refuses"] = str(e)
                continue
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"{name} at N={n} batch {batch}: max abs err {err}")
        row[f"{name}_max_abs_err"] = err
        takes[name], outs[name] = kernel, got
    for name in outs:
        if name != "this" and "this" in outs:
            row[f"{name}_differing_this"] = (outs[name] != outs["this"]).float().mean().item()
    turns = {name: [] for name in takes}
    others = [name for name in takes if name != "this"]
    for name in others + ["this", "this"] + others[::-1]:
        with launching(takes[name]):
            turns[name].append(device_ms(lambda: attention_fwd(q, k, v)))
    for name, ms in turns.items():
        row[f"{name}_ms"] = statistics.mean(ms)
        row[f"{name}_turns_ms"] = ms
    qh, kh, vh = (t(x).contiguous() for x in (q, k, v))
    row["sdpa_ms"] = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, scale=1.0))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", nargs="+", default=[], metavar="LABEL=DIR",
                    help="directories holding other attention_fwd.cu sources and headers")
    ap.add_argument("--set", nargs="+", default=[], metavar="LABEL:NAME=VALUE[,NAME=VALUE]",
                    help="copies of this tree's source with constexpr constants set otherwise")
    ap.add_argument("--lengths", nargs="+", type=int, default=None, metavar="N",
                    help="time only the shapes of these sequence lengths")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="the bodies of this dtype, at SHAPES (bfloat16) or F32_SHAPES")
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_bodies: CUDA is not available; this tool runs on a CUDA card",
              file=sys.stderr)
        return 1
    from pevit_tpu_torch.ops import attention
    from pevit_tpu_torch.ops._build import Kernel, _finish

    versions = {"this": attention.KERNEL}
    for item in args.against:
        label, _, where = item.partition("=")
        src = Path(where).resolve() / "attention_fwd.cu"
        if not where or label in versions or not src.is_file():
            raise SystemExit(f"--against {item}: want a new LABEL=DIR with attention_fwd.cu")
        versions[label] = Kernel("attention_fwd", str(src), attention.KERNEL.argtypes,
                                 replaces=attention.KERNEL.replaces)
    tmp = tempfile.TemporaryDirectory(prefix="attention_bodies_")
    for item in args.set:
        label, _, consts = item.partition(":")
        pairs = [c.partition("=") for c in consts.split(",")]
        if not consts or label in versions or any(not name or not value for name, _, value in pairs):
            raise SystemExit(f"--set {item}: want a new LABEL:NAME=VALUE[,NAME=VALUE]")
        versions[label] = source_variant(Path(tmp.name), label,
                                         **{name: value for name, _, value in pairs})
    if len(versions) == 1:
        raise SystemExit("give at least one --against or --set")
    card = card_line()
    print(card, flush=True)
    builds = {label: kernel.start_build() for label, kernel in versions.items()}
    for label, build in builds.items():
        log = _finish(build)  # "" where the library was built before
        print(f"built {label}: {versions[label].library_path().name}", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {label}: {line.strip()}", flush=True)
    lines = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = getattr(torch, args.dtype)
    for n, hd, heads, batches in (F32_SHAPES if dtype == torch.float32 else SHAPES):
        if args.lengths and n not in args.lengths:
            continue
        for batch in batches:
            row = run_shape(versions, n, hd, heads, batch, gen, dtype)
            line = json.dumps({**row, "card": card})
            print(line, flush=True)
            lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
