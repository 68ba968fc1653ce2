#!/usr/bin/env python
"""Where K1's float32 persistent body spends its cycles, on one CUDA card.

    python3 tools/k1_f32_stamps.py [B N H HD] [NAME=VALUE ...]

It builds a copy of ``attention_fwd.cu`` with ``clock64`` stamps (and, where
given, ``constexpr`` constants set otherwise), runs one float32 call at (B,
N, H, HD) (64 197 12 64 unless given), and prints, for the producer
warpgroup's thread 32 (a splitter) and each consumer warpgroup's thread 0,
the cycles a block of each phase, summed over the grid and divided by its
blocks, and each phase's share:

* splitter: waiting for a raw chunk (TMA), for its K plane stage, the
  split of K (with its fence and arrival), for its V plane stage, the
  split of V;
* consumer: waiting for K's planes, S = Q K^T, the softmax, waiting for
  V^T's planes, O += P V, a job's end.

The stamps cost a few percent (an atomic add a phase); the call's time
printed is one call's with them.  The texts it stamps after stand in the
source (``tests/test_torch_tf32_split.py`` checks them).  It needs a CUDA
card and exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# (text of attention_fwd.cu, where, what): each stamp adds the cycles since
# the one before to its phase; the texts stand once in the source
STAMP = ("#define STAMP(k) if (stamping) { const long long _n = clock64(); "
         "atomicAdd(&f32_stamps[wg * 8 + (k)], (unsigned long long)(_n - _t)); _t = _n; }\n")
EDITS = [
    ('#include "wgmma_gemm.cuh"\n', "after",
     "__device__ unsigned long long f32_stamps[24];\n" + STAMP),
    ("    // every thread splits each present entry (its count n)\n", "before",
     "    const bool stamping = tid == 32;\n    long long _t = clock64();\n"),
    ("      mbar_wait(raw_full + 8 * s, rpar);\n", "after", "      STAMP(0)\n"),
    ("      if (e >= PS) mbar_wait(k_empty + 8 * ps, ppar ^ 1);  // its consumers' S is done "
     "with it\n", "after", "      STAMP(1)\n"),
    ("      if (lane == 0) mbar_arrive(k_full + 8 * ps);\n", "after", "      STAMP(2)\n"),
    ("      if (e >= PS) mbar_wait(v_empty + 8 * ps, ppar ^ 1);  // its P V is done with it\n",
     "after", "      STAMP(3)\n"),
    ("        mbar_arrive(raw_empty + 8 * s);\n      }\n", "after", "      STAMP(4)\n"),
    ("  for (int j = paired ? 0 : c; j < mine; j += paired ? 1 : 2) {\n", "before",
     "  const bool stamping = tid == 0;\n  long long _t = clock64();\n"),
    ("\n      mbar_wait(k_full + 8 * ps, par);\n", "after", "      STAMP(0)\n"),
    ("      if (lane == 0) mbar_arrive(k_empty + 8 * ps);  // every wgmma that read it has "
     "retired\n", "after", "      STAMP(1)\n"),
    ("      // O += P V: step j's A fragment is keys 2t (a0, a1) and 2t + 1 (a2,\n", "before",
     "      STAMP(2)\n"),
    ("\n      mbar_wait(v_full + 8 * ps, par);\n", "after", "      STAMP(3)\n"),
    ("      if (lane == 0) mbar_arrive(v_empty + 8 * ps);\n", "after", "      STAMP(4)\n"),
    ("    // O / l, rows past N and columns past hd left out\n", "before", "    STAMP(5)\n"),
]
READ = ('\nextern "C" int f32_stamps_read(unsigned long long* out) '
        "{ return (int)cudaMemcpyFromSymbol(out, f32_stamps, sizeof(f32_stamps)); }\n"
        'extern "C" int f32_stamps_zero() { unsigned long long z[24] = {}; '
        "return (int)cudaMemcpyToSymbol(f32_stamps, z, sizeof(z)); }\n")
PHASES = {0: ("wait_raw", "wait_k_stage", "split_k", "wait_v_stage", "split_v"),
          1: ("wait_k", "S", "softmax", "wait_v", "PV", "job_end"),
          2: ("wait_k", "S", "softmax", "wait_v", "PV", "job_end")}


def stamped(text: str, consts: dict) -> str:
    """``attention_fwd.cu``'s text with the stamps and ``consts`` set."""
    for name, value in consts.items():
        pattern = re.compile(rf"constexpr (int|bool) {name} = [^;]+;")
        if len(pattern.findall(text)) != 1:
            raise SystemExit(f"attention_fwd.cu does not set the constexpr {name} once")
        text = pattern.sub(lambda m: f"constexpr {m.group(1)} {name} = {value};", text)
    for anchor, where, add in EDITS:
        if text.count(anchor) != 1:
            raise SystemExit(f"attention_fwd.cu no longer holds {anchor!r} once")
        text = text.replace(anchor, anchor + add if where == "after" else add + anchor)
    return text + READ


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_f32_stamps: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pevit_tpu_torch.ops import attention
    from pevit_tpu_torch.ops._build import CSRC, Kernel, _finish
    from pevit_tpu_torch.ops.attention import attention_fwd
    from pevit_tpu_torch.tools.attention_bodies import launching

    dims = [int(a) for a in argv if "=" not in a] or [64, 197, 12, 64]
    consts = dict(a.split("=", 1) for a in argv if "=" in a)
    B, n, H, hd = dims
    print(cs.card_line(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="k1_f32_stamps_"))
    shutil.copytree(CSRC, tmp / "csrc")
    src = tmp / "csrc" / "attention_fwd.cu"
    src.write_text(stamped(src.read_text(), consts))
    kern = Kernel("attention_fwd", str(src), attention.KERNEL.argtypes,
                  replaces=attention.KERNEL.replaces)
    _finish(kern.start_build())
    lib = ctypes.CDLL(str(kern.library_path()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, n, H, hd, device="cuda", generator=gen) * s
               for s in ((0.25 / hd) ** 0.25, (0.25 / hd) ** 0.25, 1.0))
    with launching(kern):
        attention_fwd(q, k, v)
        torch.cuda.synchronize()
        if lib.f32_stamps_zero() != 0:
            raise RuntimeError("could not clear the stamps")
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        attention_fwd(q, k, v)
        e1.record()
        torch.cuda.synchronize()
    got = (ctypes.c_ulonglong * 24)()
    if lib.f32_stamps_read(got) != 0:
        raise RuntimeError("could not read the stamps")
    blocks = attention.launch_plan(B, n, H, hd, torch.float32).blocks
    print(json.dumps({"shape": dims, "consts": consts, "call_ms": e0.elapsed_time(e1),
                      "blocks": blocks}), flush=True)
    for wg, names in PHASES.items():
        total = sum(got[wg * 8 + i] for i in range(len(names)))
        row = {name: {"cycles_a_block": got[wg * 8 + i] / blocks,
                      "share": got[wg * 8 + i] / max(total, 1)} for i, name in enumerate(names)}
        print(json.dumps({"warpgroup": wg, "role": "splitter" if wg == 0 else "consumer",
                          "cycles_a_block": total / blocks, "phases": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
