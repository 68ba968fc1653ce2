#!/usr/bin/env python
"""K3's float32 body against its own variants, timed in turns, on one CUDA
card.

    python3 tools/k3_fp32_variants.py

K3's float32 body (``pevit_tpu_torch/ops/csrc/fused_mlp_bwd.cu``) runs five
launches: the weights' TF32 planes, the LayerNorm rows, the GEMM pair dh
(128 x 64 tiles) and du (128 x 64 tiles) on the persistent ``wgmma`` core
(``wgmma_gemm.cuh``), and the LayerNorm backward.  This script builds the
shipped source and each variant below from a copy of the sources in a
temporary directory (the checkout is not touched), loads each library with
``ctypes`` and, at R = 6400 rows (ViT-B/32 batch 128) with C = 768 and 1024,
checks every variant against the plain version (1e-4) and times the wrapper
``fused_mlp_bwd`` with each, four turns in alternating order, beside
``gemm_ms`` (K3's three products as ``torch.matmul`` calls, TF32 off) and
beside the shipped library called straight through ``ctypes`` with its
scratch allocated once (the wrapper's Python left out).  Then it prints the
device time of each launch of the shipped body from a ``torch.profiler``
trace, and last holds the shipped body to ``chip_smoke.check_fused_mlp_bwd``
(the plain version, autograd and ``fp32_class``) at R = 5800 and 400 (C =
768) and 50 (C = 256), timed there.  Variants of the core's own choices:

* ``du_wide``: du on 128 x 128 tiles (a consumer's accumulators and three
  partials 256 registers: past setmaxnreg's 232, so ptxas spills), in a
  ring of three stages of 48 KB;
* ``dh_wide``: the GEMM pair on 128 x 128 tiles (256 registers of them),
  three stages;
* ``no_unroll``: one k-step's group at a time on a consumer (each group
  waited for before the next is issued, wait_group 0); the other
  consumer's groups still overlap.

A variant that does not build is reported and left out.
Each variant's ptxas registers and spills are printed.  The card's name
and power limit come first.  It needs a CUDA card and exits non-zero
without one, or if a variant fails to build or disagrees with the plain
version.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = "fused_mlp_bwd.cu"
CORE = "wgmma_gemm.cuh"
# a 128-column float32 stage (16 KB of A, 32 KB of B's planes) leaves room
# for three stages, which the core's ring refuses (at least four)
THREE_STAGES = (CORE, 'static_assert(STAGES >= 4 && SMEM <= SMEM_BUDGET, "four stages fit");',
                'static_assert(STAGES >= 3 && SMEM <= SMEM_BUDGET, "three stages fit");')
VARIANTS = {
    "shipped": [],
    "du_wide": [(SRC, "constexpr int DU_F32_TILE_N = 64;", "constexpr int DU_F32_TILE_N = 128;"),
                THREE_STAGES],
    "dh_wide": [(SRC, "constexpr int DH_F32_TILE_N = 64;", "constexpr int DH_F32_TILE_N = 128;"),
                THREE_STAGES],
    "no_unroll": [(CORE, 'asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(P - 1) : "memory");',
                   'asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(0) : "memory");')],
}


def kernel_name(key: str) -> str:
    """``gemm_dh_tf32`` or ``ln_bwd_rows<float, 24>`` from a profiler key
    such as ``void (anonymous namespace)::ln_bwd_rows<float, 24>(float
    const*, ...)``."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key[:key.index("(")] if "(" in key else key


def build(csrc: Path, tmp: Path) -> dict:
    """Every variant's library, built at once from edited copies of csrc."""
    from pevit_tpu_torch.ops import _build

    procs = {}
    for name, edits in VARIANTS.items():
        d = tmp / name
        shutil.copytree(csrc, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {fname} no longer holds the text it edits once")
            (d / fname).write_text(text.replace(old, new))
        out = d / "lib.so"
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(d / SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_fp32_variants: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from pevit_tpu_torch.ops import _build, fused_mlp as fm

    print(cs.card_line(), flush=True)
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (out, proc) in build(_build.CSRC, Path(tmp)).items():
            log, _ = proc.communicate()
            if proc.returncode:
                print(f"{name}: nvcc failed, left out\n{log[-4000:]}", flush=True)
                if name == "shipped":
                    return 1
                continue
            for line in cs.ptxas_summary(name, log):
                if "_tf32" in line or "split_weights" in line:
                    print(line, flush=True)
            fn = getattr(ctypes.CDLL(str(out)), "fused_mlp_bwd")
            fn.argtypes, fn.restype = fm.BWD_KERNEL.argtypes, ctypes.c_int
            fns[name] = fn

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = cs.TRAIN_BATCH * 50
    for c in (768, 1024):
        f = 4 * c
        r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
        x, dy = r(rows, c), r(rows, c)
        ln_s, ln_b = 1 + 0.1 * r(c), 0.1 * r(c)
        wfc, bfc, wproj = r(c, f) * c ** -0.5, 0.1 * r(f), r(f, c) * f ** -0.5
        args = (dy, x, ln_s, ln_b, wfc, bfc, wproj)
        want = fm.fused_mlp_bwd_ref(*args)
        work = torch.empty(fm.bwd_workspace_bytes(torch.float32, rows, c, f),
                           dtype=torch.uint8, device="cuda")
        dx = torch.empty_like(x)
        argv = (dy.data_ptr(), x.data_ptr(), *(t.data_ptr() for t in args[2:]),
                work.data_ptr(), dx.data_ptr(), 0, rows, c, f, c, 1e-5,
                torch.cuda.current_stream().cuda_stream)
        u, dh = r(rows, c), r(rows, f)

        def run(name):
            fm.BWD_KERNEL._fn = fns[name]
            return fm.fused_mlp_bwd(*args)

        for name in fns:
            err = (run(name) - want).abs().max().item()
            if not err <= 1e-4:
                print(f"C={c} {name}: max abs err {err} vs the plain version", flush=True)
                return 1
        cases = {name: (lambda name=name: run(name)) for name in fns}
        cases["shipped_direct"] = lambda: fns["shipped"](*argv)
        cases["gemm_ms"] = lambda: (u @ wfc, dy @ wproj.T, dh @ wfc.T)
        times = {name: [] for name in cases}
        for turn in range(4):
            for name in (list(cases) if turn % 2 == 0 else list(cases)[::-1]):
                times[name].append(cs.time_ms(cases[name], reps=10))
        print(f"R={rows} C={c} ms: " + json.dumps({n: sorted(t) for n, t in times.items()}),
              flush=True)
        fm.BWD_KERNEL._fn = fns["shipped"]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fm.fused_mlp_bwd(*args)
            torch.cuda.synchronize()
        launches = {kernel_name(e.key): e.device_time_total / 5 / 1e3
                    for e in prof.key_averages() if e.device_time_total > 0}
        print(f"R={rows} C={c} shipped device ms a call: " + json.dumps(launches), flush=True)
    fm.BWD_KERNEL._fn = fns["shipped"]
    for rows, c in ((5800, 768), (400, 768), (50, 256)):
        row = cs.check_fused_mlp_bwd(gen, torch.float32, c, rows)
        print(f"shipped at R={rows} C={c}: " + json.dumps(row), flush=True)
    fm.BWD_KERNEL._fn = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
