"""Where a tile's time goes in the fused MLP's GEMM core, bf16 or float32,
split by ``clock64`` stamps on one CUDA card.

    python3 tools/gemm_stamps.py [--shapes KIND:R:C:F ...]

The core (``gemm_persistent`` in ``pevit_tpu_torch/ops/csrc/wgmma_gemm.cuh``)
is copied to a temporary directory with stamps added to its consumers'
loop (``STAMPS``: each an edit of the source text; the tool stops if one
no longer applies), and K2 (``fwd``) and K3 (``bwd``) are built from the copy
and run through this checkout's wrappers at each row of ``--shapes``
(default: K2 at R = 12800 and K3 at R = 6400, C = 768, in bf16 and, as
``fwd32`` and ``bwd32``, in float32).  Thread 0 of each
consumer warpgroup sums, over the tiles it takes, the cycles of five
phases: ``turn`` (bf16: waiting for the other consumer to have issued its
main loop; float32: for the tile's first stage), ``issue`` (issuing the
tile's wgmma groups, each after its ring stage is full; float32: with
every group's add), ``drain`` (bf16: the last groups' completion;
float32: none), ``epilogue``, and ``tiles``, into a slot for each of a
call's two GEMMs (K < N: K2's
``fc``, K3's ``dh``; else ``proj``, ``du``: F > C at every model width);
the sums are read back after one call and printed as the mean cycles a
tile of each phase and consumer, beside the device ms of the call.  A
measurement aid, never on a path: the stamps cost a few instructions a
tile.  One JSON line a row, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

PHASES = ("turn", "issue", "drain", "epilogue", "tiles")
MAX_BLOCKS = 1024
# (file, text, the text it becomes): the stamps, each text found once;
# the bf16 consumers' five phases, and the float32 consumers' (their
# ``turn`` the wait for a tile's first stage, ``drain`` zero: each turn of
# their loop waits for its own groups)
_CORE = "wgmma_gemm.cuh"
_TICK = "unsigned long long sums[5] = {0, 0, 0, 0, 0}, t0, t1, t2, t3;\n"
_SUM = ("sums[0] += t1 - t0, sums[1] += t2 - t1, sums[2] += t3 - t2, sums[3] += t4 - t3;\n"
        "++sums[4];\n")
STAMPS = [
    (_CORE, "// the GEMM core\n// -----",
     "// the GEMM core\n"
     "__device__ unsigned long long gemm_stamp_sums[2][1024][2][5];\n// -----"),
    (_CORE, "  };\n  int it = 0;\n  if constexpr (TF32) {\n",
     "  };\n  int it = 0;\n  " + _TICK + "  if constexpr (TF32) {\n"),
    # float32
    (_CORE, "      mbar_wait(full + 8 * (it % ST), (it / ST) & 1);\n      load_a(raw, it, 0);\n"
            "      split();\n",
     "      t0 = clock64();\n"
     "      mbar_wait(full + 8 * (it % ST), (it / ST) & 1);\n      load_a(raw, it, 0);\n"
     "      split();\n      t1 = clock64();\n"),
    (_CORE, "#pragma unroll\n      for (int p = 0; p < NP; ++p)\n#pragma unroll\n"
            "        for (int i = 0; i < L::ACC; ++i) fence_operand(acc[p][i]);\n",
     "      t2 = t3 = clock64();\n#pragma unroll\n      for (int p = 0; p < NP; ++p)\n"
     "#pragma unroll\n        for (int i = 0; i < L::ACC; ++i) fence_operand(acc[p][i]);\n"),
    (_CORE, "      epilogue(acc, row0 + 64 * c + 16 * warp, n0, epi);\n",
     "      epilogue(acc, row0 + 64 * c + 16 * warp, n0, epi);\n"
     "      const unsigned long long t4 = clock64();\n" + _SUM),
    # bf16
    (_CORE, "      if (j > 0)  // this consumer's turn",
     "      t0 = clock64();\n      if (j > 0)  // this consumer's turn"),
    (_CORE, "      for (int ks = 0; ks < ksteps; ++ks)\n#pragma unroll\n"
            "        for (int p = 0; p < NP; ++p, ++it) {\n          const int s = it % ST;\n",
     "      t1 = clock64();\n      for (int ks = 0; ks < ksteps; ++ks)\n#pragma unroll\n"
     "        for (int p = 0; p < NP; ++p, ++it) {\n          const int s = it % ST;\n"),
    (_CORE, "      // the other consumer's turn (tile j + 1",
     "      t2 = clock64();\n      // the other consumer's turn (tile j + 1"),
    (_CORE, "      release(it - 1);\n#pragma unroll\n      for (int h = 0; h < 2; ++h)\n",
     "      release(it - 1);\n      t3 = clock64();\n#pragma unroll\n"
     "      for (int h = 0; h < 2; ++h)\n"),
    (_CORE, "epilogue(acc[h], row0 + 64 * h + 16 * warp, n0, epi);\n",
     "epilogue(acc[h], row0 + 64 * h + 16 * warp, n0, epi);\n"
     "      const unsigned long long t4 = clock64();\n" + _SUM),
    (_CORE, "  }\n}\n\n// 1 / x, IEEE round to nearest",
     "  }\n  if (threadIdx.x % 128 == 0 && blockIdx.x < 1024)\n"
     "    for (int i = 0; i < 5; ++i)\n"
     "      gemm_stamp_sums[K < N ? 0 : 1][blockIdx.x][c][i] = sums[i];\n"
     "}\n\n// 1 / x, IEEE round to nearest"),
]
READER = """
extern "C" int gemm_stamps_read(void* out) {
  int err = (int)cudaMemcpyFromSymbol(out, gemm_stamp_sums, sizeof gemm_stamp_sums);
  if (err == 0) err = (int)cudaMemset(gemm_stamp_sums_address(), 0, sizeof gemm_stamp_sums);
  return err;
}
"""
ADDRESS = """
namespace {
void* gemm_stamp_sums_address() {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, gemm_stamp_sums);
  return p;
}
}  // namespace
"""


def stamped_sources(dst: Path) -> Path:
    """This checkout's csrc copied to ``dst`` with the stamps added."""
    from pevit_tpu_torch.ops._build import CSRC

    shutil.copytree(CSRC, dst)
    for name, old, new in STAMPS:
        path = dst / name
        text = path.read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{name} no longer holds a stamp's text once: {old[:60]!r}")
        path.write_text(text.replace(old, new))
    for name in ("fused_mlp_fwd.cu", "fused_mlp_bwd.cu"):
        path = dst / name
        path.write_text(path.read_text() + ADDRESS + READER)
    return dst


def read_sums(lib) -> list:
    """[[{phase: sum over blocks} for each consumer] for each GEMM slot] of
    the launches since the last read, then zeroed."""
    buf = (ctypes.c_ulonglong * (2 * MAX_BLOCKS * 2 * 5))()
    fn = lib.gemm_stamps_read
    fn.argtypes = [ctypes.c_void_p]
    if fn(ctypes.addressof(buf)) != 0:
        raise RuntimeError("gemm_stamps_read failed")
    at = lambda slot, b, c, i: buf[((slot * MAX_BLOCKS + b) * 2 + c) * 5 + i]
    return [[dict(zip(PHASES, [sum(at(slot, b, c, i) for b in range(MAX_BLOCKS))
                               for i in range(5)])) for c in range(2)] for slot in range(2)]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("gemm_stamps: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", nargs="+", default=["fwd:12800:768:3072", "bwd:6400:768:3072",
                                                          "fwd32:12800:768:3072",
                                                          "bwd32:6400:768:3072"])
    args = parser.parse_args(argv)
    import chip_smoke as cs
    from fused_mlp_ab import calls, inputs
    from kernel_ab import launching
    from pevit_tpu_torch.ops import fused_mlp
    from pevit_tpu_torch.ops._build import Kernel, build_all
    from pevit_tpu_torch.tools.attention_bodies import device_ms
    from pevit_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="gemm_stamps_") as tmp:
        src = stamped_sources(Path(tmp) / "csrc")
        kernels = {k.name: Kernel(k.name, str(src / k.source.name), k.argtypes, k.replaces)
                   for k in (fused_mlp.KERNEL, fused_mlp.BWD_KERNEL)}
        build_all(kernels.values())
        gen = torch.Generator(device="cuda").manual_seed(0)
        for shape in args.shapes:
            kind, *rest = shape.split(":")
            R, C, F = map(int, rest)
            f32 = kind.endswith("32")
            name, run, plain, _, _ = calls(kind, inputs(gen, R, C, F,
                                                        kind.removesuffix("32").endswith("x"),
                                                        torch.float32 if f32 else None))
            kernel = kernels[name]
            with launching(name, kernel):
                tol = 1e-4 if f32 else 2e-2
                cs.check_close(f"{name} stamped", run(), plain(), tol, tol)
                ms = device_ms(run)
                lib = ctypes.CDLL(str(kernel.library_path()))
                read_sums(lib)  # zero what the timing left
                run()
                torch.cuda.synchronize()
                sums = read_sums(lib)
            row = {"kernel": name, "kind": kind, "R": R, "C": C, "F": F, "ms": ms}
            gemms = ("fc", "proj") if name == "fused_mlp_fwd" else ("dh", "du")
            for gemm, slot in zip(gemms, sums):
                for c, s in enumerate(slot):
                    n = max(s["tiles"], 1)
                    row[f"{gemm}_consumer{c}"] = {"tiles": s["tiles"],
                                                  **{p: s[p] / n for p in PHASES[:4]}}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
