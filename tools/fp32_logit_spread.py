"""How K1's float32 body's error against float64 moves with the spread of
the logits, on one CUDA card.

    python3 tools/fp32_logit_spread.py

At head width 64 and 80, N = 197, 64 images of 16 heads, q and k drawn so
that the logits have a standard deviation of 0.5 (phase 3's spread), 0.8,
1.0 and 1.4, it prints for the kernel (``attention_fwd``) and the plain
float32 version (``attention_ref``, cuBLAS with TF32 off) the max abs error
against a float64 run and the bias, the mean error signed toward the
float64 result relative to it, as ``chip_smoke.fp32_class`` computes them,
beside the floor of that check's bias bound (half a float32 ulp).  One
JSON line a row, the card's name and power limit first.  Nothing is held:
it measures.  It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SPREADS = (0.5, 0.8, 1.0, 1.4)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fp32_logit_spread: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pevit_tpu_torch.ops.attention import attention_fwd, attention_ref
    from pevit_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = lambda x: x.transpose(1, 2)
    for hd in (64, 80):
        for spread in SPREADS:
            # logits of std ``spread``: q and k entries of std (spread^2 / hd) ** 0.25
            s = (spread ** 2 / hd) ** 0.25
            q, k, v = (torch.randn(64, 197, 16, hd, device="cuda", generator=gen) * c
                       for c in (s, s, 1.0))
            want = cs.attention_f64(q, k, v)
            row = {"hd": hd, "logit_std": spread, "half_ulp": cs.FP32_HALF_ULP}
            for name, out in (("kernel", attention_fwd(q, k, v)),
                              ("plain", t(attention_ref(t(q), t(k), t(v))))):
                err = (out.double() - want).abs().max().item()
                bias = ((out.double() - want) * want).sum().item() / want.square().sum().item()
                row.update({f"{name}_err_f64": err, f"{name}_bias_f64": bias})
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
