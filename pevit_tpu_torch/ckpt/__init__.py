"""CLIP weights for the port's entry points.

Counterpart of ``pevit_tpu/ckpt`` (``torch_loader.load_clip``), random
branch only: reading a checkpoint into the port waits for ROADMAP §1
"Checkpoint I/O".  The resolution order is the reference's
(``pevit_tpu/ckpt/torch_loader.py:266-313``): ``"random"``, then an explicit
path, then the CLIP cache dir, then random init.  Where a checkpoint file is
found, ``load_clip`` raises; it never falls back to random weights in its
place.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from ..core.clip import CLIPSpec, init_clip_params

MODEL_CKPT_NAMES = {
    "ViT-B/32": "ViT-B-32.pt",
    "ViT-B/16": "ViT-B-16.pt",
    "ViT-L/14": "ViT-L-14.pt",
    "RN50": "RN50.pt",
    "RN101": "RN101.pt",
    "RN50x4": "RN50x4.pt",
    "RN50x16": "RN50x16.pt",
    "RN50x64": "RN50x64.pt",
}


def load_clip(model_name: str = "ViT-B/32", *, checkpoint_path: Optional[str] = None,
              cache_dir: str = "~/.cache/clip", allow_random: bool = True, seed: int = 0,
              spec_hint: Optional[CLIPSpec] = None, device=None) -> tuple:
    """(clip, spec) for ``model_name`` on ``device``.  Random weights are
    drawn from a CPU generator seeded ``seed``, for ``spec_hint`` or else the
    name's ViT preset."""
    def random():
        logging.warning("=> NO pretrained weights for %s; RANDOM-init CLIP (benchmarks/tests only)",
                        model_name)
        if spec_hint is not None:
            spec = spec_hint
        elif model_name.startswith("RN"):
            raise NotImplementedError("ResNet CLIP towers are not ported (ROADMAP §1, "
                                      "auxiliary backbones)")
        else:
            spec = CLIPSpec.vit_b16() if "16" in model_name else CLIPSpec.vit_b32()
        return init_clip_params(torch.Generator().manual_seed(seed), spec, device=device), spec

    if checkpoint_path == "random":
        return random()
    path = checkpoint_path or None
    if path is None:
        fname = MODEL_CKPT_NAMES.get(model_name)
        if fname:
            cand = os.path.expanduser(os.path.join(cache_dir, fname))
            if os.path.exists(cand):
                path = cand
    if path and os.path.exists(path):
        raise NotImplementedError(
            f"found the checkpoint {path}, but reading checkpoints into the port is not ported "
            "yet (ROADMAP §1, checkpoint I/O); pass MODEL.PRETRAINED random for random weights")
    if not allow_random:
        raise FileNotFoundError(
            f"No checkpoint for {model_name!r} (tried {path!r}); downloads are disabled")
    return random()
