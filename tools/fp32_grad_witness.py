#!/usr/bin/env python
"""How far sound float32 arithmetic moves the ViT-B/16 finetune's
first-step gradients, on one CUDA card.

    python3 tools/fp32_grad_witness.py

The finetune is ``chip_smoke.py`` phase 10's: ``commands.finetune`` on
synthetic cifar-10 with ``vit_base_patch16_224.yaml`` and a seeded timm
checkpoint.  Its float32 first-step gradients are taken on three
attentions under one seed and batch:

* ``plain``: the plain version (cuBLAS, TF32 off), the reference of the
  other two;
* ``kernel``: the port's attention kernel (K1's float32 body);
* ``rounded_f64``: the attention computed in float64, forward and
  backward, and rounded to float32 at its output and its gradients.

For ``kernel`` and ``rounded_f64`` it prints one JSON line: each leaf's
gap to ``plain`` on the leaf's own size (max |g - g_plain| / max
|g_plain|) for the three leaves with the largest gaps, and every leaf's
size against the tower's largest |g|.  A leaf whose gap under
``rounded_f64`` is as large as under ``kernel`` is one whose gradient is
mostly rounding, so a limit on it that the kernel misses asks for
cuBLAS's sums bit for bit.  The card's name and power limit are printed
first.  It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SHOWN = 3


@contextlib.contextmanager
def rounded_f64_attention():
    """The plain path, with the blocks' attention computed in float64
    (forward and backward) and rounded to float32."""
    from pevit_tpu_torch.core import layers

    with cs.plain_path():
        layers.attention_core = lambda q, k, v: cs.attention_f64(q, k, v).to(q.dtype)
        yield


def gaps(got: dict, want: dict) -> dict:
    """Each leaf's gap to ``want`` on its own size, and its size against
    the largest |g| of ``want``."""
    scale = max(w.abs().max().item() for w in want.values())
    out = {}
    for n, w in want.items():
        size = w.abs().max().item()
        out[n] = {"gap": (got[n] - w).abs().max().item() / size if size else 0.0,
                  "rel_size": size / scale}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("fp32_grad_witness: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    from pevit_tpu_torch.commands import finetune
    from pevit_tpu_torch.ops import KERNELS, build_all

    print(cs.card_line(), flush=True)
    build_all(KERNELS)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        ckpt = tmp / "vit_base_patch16_224.pth"
        cs.write_timm_checkpoint(ckpt)
        _, task, data, _, _ = cs.run_aux_command(
            KERNELS, finetune,
            cs.aux_argv(tmp / "vit_ft", "vit_base_patch16_224.yaml", "--lr", "1e-5", "--l2",
                        "0.0001", "TEST.MODEL_FILE", str(ckpt)),
            lambda t, d: cs.aux_batches(t, d, 197, fused_mlp=False))
    images, labels = data[0][:cs.AUX_BATCH], data[1][:cs.AUX_BATCH]
    task = copy.copy(task)
    task.static = dataclasses.replace(task.static, compute_dtype="float32")
    with cs.plain_path():
        want = cs.first_step_grads(task, images, labels)
    paths = {"kernel": contextlib.nullcontext, "rounded_f64": rounded_f64_attention}
    for name, ctx in paths.items():
        with ctx():
            got = cs.first_step_grads(task, images, labels)
        by_leaf = gaps(got, want)
        top = sorted(by_leaf, key=lambda n: by_leaf[n]["gap"], reverse=True)[:SHOWN]
        print(f"vit_b16 finetune fp32 {name} vs plain "
              f"{json.dumps({n: by_leaf[n] for n in top})}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
