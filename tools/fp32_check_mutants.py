#!/usr/bin/env python
"""Which broken float32 bodies ``chip_smoke.py``'s float32 checks refuse,
on one CUDA card.

    python3 tools/fp32_check_mutants.py

The float32 bodies of K1, K2 and K3 sum three TF32 products a k-step of 8
on the tensor cores, from zero, and add that partial sum to a float32
accumulator once, rounded (``pevit_tpu_torch/ops/csrc/attention_fwd.cu``'s
``tf32x3_step`` for K1's persistent body; ``wgmma_gemm.cuh``: the GEMM
core's group, under K2 and K3; both add with ``add_partial``).  The tensor core truncates as it accumulates, so every variant
below that lets more of the sum run on the tensor core, or truncates the
add, leaves its results biased toward zero.  For the shipped sources and
for each variant, built from a copy of the sources in a temporary
directory (the checkout is not touched), it runs phase 3's and 3b's
float32 rows through ``chip_smoke``'s own checks (``check_attention``: N =
50, 197, 257 at batch 256 and N = 197 at batch 64; ``check_fused_mlp``: C =
768 and 1024 at R = 12800; ``check_fused_mlp_bwd``: C = 768 and 1024 at R =
6400) and prints one JSON line a row: passed, or the check that refused
it, with ``fp32_class``'s readings.  Variants, each made in both forms
where it names all three kernels:

* ``bigfirst``: the k-step's hi·hi product first, the small ones added to it;
* ``rz``: the partial sum added to the accumulator rounding toward zero;
* ``chain``: every product accumulated on the tensor core, no rounded add;
* ``k1_pairs``: K1's k-steps two to a chain (six products) before the add,
  in S and in P V;
* ``k3_pairs``: the same in the GEMM core that K2 and K3 share
  (``wgmma_gemm.cuh``).

A last line gives, for each variant and each kernel it changes, whether
some row of that kernel was refused.  It exits non-zero if the shipped
bodies fail a row or a variant does not build.  The card's name and power
limit are printed first.  It needs a CUDA card and exits non-zero without
one.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = Path("pevit_tpu_torch/ops/csrc")

_K1 = "attention_fwd.cu"
# K1's float32 group (a k-step of a 64-row tile, S's or P V's), its two
# calls and their adds
_K1_STEP = ("  WgmmaTf32<NW>::mma(part, lo, b_hi, 0);  // from zero, the small terms first\n"
            "  WgmmaTf32<NW>::mma(part, hi, b_lo, 1);\n"
            "  WgmmaTf32<NW>::mma(part, hi, b_hi, 1);\n")
_K1_S = "tf32x3_step<NKC>(sp[kk % L::SP], hi, lo, wgmma_desc(kb), wgmma_desc(kb + L::K_PLANE));"
_K1_PV = "tf32x3_step<W>(op[j % L::VP], hi, lo, wgmma_desc(vb), wgmma_desc(vb + L::VT_PLANE));"
_K1_S_ADD = "[&](auto kc) { add_partial(s, sp[decltype(kc)::value % L::SP]); });"
_K1_PV_ADD = "[&](auto jc) { add_partial(o, op[decltype(jc)::value % L::VP]); });"
# the GEMM core's float32 group (a k-step of one 64-row half) and its add,
# which K1's float32 body shares (add_partial)
_CORE = "wgmma_gemm.cuh"
_GROUP = ("          WgmmaTf32<BN>::mma(part[q % P], lo, b_hi, 0);  // from zero, the small terms "
          "first\n"
          "          WgmmaTf32<BN>::mma(part[q % P], hi, b_lo, 1);\n"
          "          WgmmaTf32<BN>::mma(part[q % P], hi, b_hi, 1);\n")
_CORE_ADD = "    acc[i] += part[i];\n"
_ADD_GROUP = "          add_partial(acc[q / KS % NP], part[q % P]);\n"

ALL = ("attention_fwd", "fused_mlp_fwd", "fused_mlp_bwd")
# variant: (the kernels it changes, [(file, old text, new text), ...])
VARIANTS = {
    "bigfirst": (ALL, [(_K1, _K1_STEP,
                        "  WgmmaTf32<NW>::mma(part, hi, b_hi, 0);\n"
                        "  WgmmaTf32<NW>::mma(part, lo, b_hi, 1);\n"
                        "  WgmmaTf32<NW>::mma(part, hi, b_lo, 1);\n"),
                       (_CORE, _GROUP,
                        "          WgmmaTf32<BN>::mma(part[q % P], hi, b_hi, 0);\n"
                        "          WgmmaTf32<BN>::mma(part[q % P], lo, b_hi, 1);\n"
                        "          WgmmaTf32<BN>::mma(part[q % P], hi, b_lo, 1);\n")]),
    # add_partial is K1's add too
    "rz": (ALL, [(_CORE, _CORE_ADD, "    acc[i] = __fadd_rz(acc[i], part[i]);\n")]),
    "chain": (ALL, [(_K1, _K1_STEP, _K1_STEP.replace(
                         "b_hi, 0);  // from zero, the small terms first", "b_hi, 1);")),
                    (_K1, _K1_S, _K1_S.replace("sp[kk % L::SP]", "s")),
                    (_K1, _K1_PV, _K1_PV.replace("op[j % L::VP]", "o")),
                    (_CORE, _GROUP, _GROUP.replace("part[q % P]", "acc[q / KS % NP]").replace(
                        "b_hi, 0);  // from zero, the small terms first", "b_hi, 1);")),
                    (_CORE, _CORE_ADD, "    (void)acc[i];\n")]),
    # a pair of k-steps (an even one and the next) shares a partial: the even
    # one's group starts it, the odd one's adds to it on the tensor core,
    # and only the odd one's is added (S's and P V's k-steps are even counts)
    "k1_pairs": (("attention_fwd",), [
        (_K1, "                                            uint64_t b_lo) {\n",
         "                                            uint64_t b_lo, int scale = 0) {\n"),
        (_K1, "  WgmmaTf32<NW>::mma(part, lo, b_hi, 0);  // from zero, the small terms first\n",
         "  WgmmaTf32<NW>::mma(part, lo, b_hi, scale);\n"),
        (_K1, _K1_S, _K1_S.replace("sp[kk % L::SP]", "sp[kk / 2 % L::SP]").replace(
            "L::K_PLANE));", "L::K_PLANE), kk % 2);")),
        (_K1, _K1_PV, _K1_PV.replace("op[j % L::VP]", "op[j / 2 % L::VP]").replace(
            "L::VT_PLANE));", "L::VT_PLANE), j % 2);")),
        (_K1, _K1_S_ADD, "[&](auto kc) { if (decltype(kc)::value % 2 == 1) "
         "add_partial(s, sp[decltype(kc)::value / 2 % L::SP]); });"),
        (_K1, _K1_PV_ADD, "[&](auto jc) { if (decltype(jc)::value % 2 == 1) "
         "add_partial(o, op[decltype(jc)::value / 2 % L::VP]); });"),
    ]),
    # the same in the GEMM core that K2 and K3 share
    "k3_pairs": (("fused_mlp_fwd", "fused_mlp_bwd"), [
        (_CORE, _GROUP,
         _GROUP.replace("part[q % P]", "part[q / 2 % P]").replace(
             "b_hi, 0);  // from zero, the small terms first", "b_hi, kk % 2);")),
        (_CORE, _ADD_GROUP,
         "          if (q % 2 == 1) add_partial(acc[q / KS % NP], part[q / 2 % P]);\n"),
    ]),
}


def checkout_copy(dst: Path, variant: str) -> None:
    """The package and ``chip_smoke.py`` under ``dst``, with ``variant``'s
    edits made to the copy's kernel sources."""
    shutil.copytree(REPO / "pevit_tpu_torch", dst / "pevit_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", dst)
    for name, old, new in VARIANTS.get(variant, (None, []))[1]:
        path = dst / CSRC / name
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{variant}: {name} no longer holds the text it edits once")
        path.write_text(text.replace(old, new))


def rows() -> int:
    """In a copy: phase 3's float32 rows through chip_smoke's checks."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from pevit_tpu_torch.ops import KERNELS, build_all

    if not Path(cs.__file__).resolve().is_relative_to(Path.cwd().resolve()):
        raise SystemExit(f"chip_smoke imported from {cs.__file__}, not the copy")
    build_all(KERNELS)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("attention_fwd", lambda n=n: cs.check_attention(gen, torch.float32, n))
             for n in (50, 197, 257)]
    cases.append(("attention_fwd", lambda: cs.check_attention(gen, torch.float32, 197, 64)))
    cases += [("fused_mlp_fwd", lambda c=c: cs.check_fused_mlp(gen, torch.float32, c, 12800))
              for c in (768, 1024)]
    cases += [("fused_mlp_bwd", lambda c=c: cs.check_fused_mlp_bwd(gen, torch.float32, c, 6400))
              for c in (768, 1024)]
    keys = ("shape", "max_abs_err", "err_f64", "plain_err_f64", "tf32_err_f64", "bias_f64",
            "plain_bias_f64", "tf32_bias_f64")
    for kernel, case in cases:
        try:
            row = case()
            out = {"kernel": kernel, "passed": True, **{k: row[k] for k in keys}}
        except AssertionError as e:
            out = {"kernel": kernel, "passed": False, "refused_by": str(e)}
        print("ROW " + json.dumps(out), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fp32_check_mutants: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    caught, ok = {}, True
    for variant in ("shipped", *VARIANTS):
        with tempfile.TemporaryDirectory() as tmp:
            checkout_copy(Path(tmp), variant)
            run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--rows"],
                                 cwd=tmp, capture_output=True, text=True)
        got = [json.loads(line[4:]) for line in run.stdout.splitlines()
               if line.startswith("ROW ")]
        if run.returncode != 0 or len(got) != 8:
            print(f"{variant}: failed (rc {run.returncode})\n{run.stderr[-4000:]}", flush=True)
            ok = False
            continue
        for row in got:
            print(f"{variant} {json.dumps(row)}", flush=True)
        if variant == "shipped":
            ok &= all(r["passed"] for r in got)
        else:
            caught[variant] = {k: any(not r["passed"] for r in got if r["kernel"] == k)
                               for k in VARIANTS[variant][0]}
    print(json.dumps({"shipped_passed": ok, "caught": caught}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(rows() if sys.argv[1:] == ["--rows"] else main())
