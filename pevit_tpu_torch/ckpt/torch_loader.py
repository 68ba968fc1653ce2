"""OpenAI CLIP checkpoint -> the port's ``CLIP``.

Counterpart of ``pevit_tpu/ckpt/torch_loader.py``, ViT branch.  A ``.pt``
file (a TorchScript archive, or a pickle with an optional ``state_dict`` /
``model`` wrapper) is read on the CPU, its architecture is inferred from the
key shapes, and the weights are converted once into the reference's
kernel-convention tree:

* Linear weights ``(out, in)`` transpose to ``(in, out)`` kernels;
* the patchify conv ``(width, 3, p, p)`` flattens to the ``(p*p*3, width)``
  GEMM kernel that ``core.clip.patchify_images`` feeds;
* per-layer block tensors stack on a leading layer axis.

``bridge.clip_from_jax`` then unstacks that tree into the port's ``CLIP``,
so a checkpoint lands in the port bit for bit as it lands in the reference.
ResNet checkpoints raise: the RN towers are not ported.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from ..core.clip import CLIP, CLIPSpec, TextSpec, VisionSpec, init_clip_params

# canonical OpenAI checkpoint names accepted by MODEL.NAME (clip_load.py:30-41)
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
_RN_UNPORTED = "ResNet CLIP towers are not ported (ROADMAP §1, auxiliary backbones)"


def _text_spec_from_state_dict(sd: dict) -> TextSpec:
    transformer_width = sd["ln_final.weight"].shape[0]
    return TextSpec(
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        width=transformer_width,
        heads=max(1, transformer_width // 64),
        layers=len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}),
        output_dim=sd["text_projection"].shape[1],
    )


def infer_spec_from_state_dict(sd: dict) -> CLIPSpec:
    """Architecture inference from checkpoint key shapes (model.py:1210-1233).
    A ResNet checkpoint (no ``visual.proj``) raises NotImplementedError."""
    if "visual.proj" not in sd:
        raise NotImplementedError(_RN_UNPORTED)
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_layers = len(
        [k for k in sd if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")]
    )
    vision_patch_size = sd["visual.conv1.weight"].shape[-1]
    grid_size = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    text = _text_spec_from_state_dict(sd)
    return CLIPSpec(
        embed_dim=text.output_dim,
        vision=VisionSpec(
            input_resolution=vision_patch_size * grid_size,
            patch_size=vision_patch_size,
            width=vision_width,
            layers=vision_layers,
            heads=max(1, vision_width // 64),
            output_dim=text.output_dim,
        ),
        text=text,
    )


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _stack_blocks(sd: dict, prefix: str, n_layers: int) -> dict:
    def stacked(key, transpose=False):
        arrs = [sd[f"{prefix}.{i}.{key}"] for i in range(n_layers)]
        return np.stack([a.T if transpose else a for a in arrs])

    return {
        "attn": {
            "in_proj": {"kernel": stacked("attn.in_proj_weight", transpose=True),
                        "bias": stacked("attn.in_proj_bias")},
            "out_proj": {"kernel": stacked("attn.out_proj.weight", transpose=True),
                         "bias": stacked("attn.out_proj.bias")},
        },
        "mlp": {
            "c_fc": {"kernel": stacked("mlp.c_fc.weight", transpose=True),
                     "bias": stacked("mlp.c_fc.bias")},
            "c_proj": {"kernel": stacked("mlp.c_proj.weight", transpose=True),
                       "bias": stacked("mlp.c_proj.bias")},
        },
        "ln_1": {"scale": stacked("ln_1.weight"), "bias": stacked("ln_1.bias")},
        "ln_2": {"scale": stacked("ln_2.weight"), "bias": stacked("ln_2.bias")},
    }


def state_dict_to_params(sd: dict) -> tuple:
    """A torch state dict (tensors or numpy) -> (the reference's CLIP tree as
    float32 numpy, spec)."""
    sd = {k: np.asarray(v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else v,
                        np.float32)
          for k, v in sd.items() if hasattr(v, "shape") or np.isscalar(v)}
    spec = infer_spec_from_state_dict(sd)
    v = spec.vision
    conv = sd["visual.conv1.weight"]  # (width, 3, p, p)
    patch_kernel = conv.transpose(2, 3, 1, 0).reshape(v.patch_size * v.patch_size * 3, v.width)
    params = {
        "visual": {
            "patch_embed": {"kernel": patch_kernel},
            "class_embedding": sd["visual.class_embedding"],
            "positional_embedding": sd["visual.positional_embedding"],
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "blocks": _stack_blocks(sd, "visual.transformer.resblocks", v.layers),
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": sd["visual.proj"],
        },
        "text": {
            "token_embedding": sd["token_embedding.weight"],
            "positional_embedding": sd["positional_embedding"],
            "blocks": _stack_blocks(sd, "transformer.resblocks", spec.text.layers),
            "ln_final": _ln(sd, "ln_final"),
            "text_projection": sd["text_projection"],
        },
        "logit_scale": sd["logit_scale"].reshape(()),
    }
    return params, spec


def clip_to_state_dict(clip: CLIP) -> dict:
    """The inverse of :func:`state_dict_to_params`: the port's ``CLIP`` ->
    an OpenAI-layout state dict of float32 CPU tensors (``(out, in)`` Linear
    weights, the patchify conv, ``transformer.resblocks.<i>`` blocks)."""
    cpu = lambda t: t.detach().float().cpu()
    vis, txt = clip.visual, clip.text
    width = vis.class_embedding.shape[0]
    p = round((vis.patch_embed.kernel.shape[0] // 3) ** 0.5)
    sd = {
        "visual.class_embedding": cpu(vis.class_embedding),
        "visual.positional_embedding": cpu(vis.positional_embedding),
        "visual.proj": cpu(vis.proj),
        "visual.conv1.weight": cpu(vis.patch_embed.kernel).reshape(p, p, 3, width)
        .permute(3, 2, 0, 1).contiguous(),
        "token_embedding.weight": cpu(txt.token_embedding),
        "positional_embedding": cpu(txt.positional_embedding),
        "text_projection": cpu(txt.text_projection),
        "logit_scale": cpu(clip.logit_scale),
    }
    for prefix, ln in (("visual.ln_pre", vis.ln_pre), ("visual.ln_post", vis.ln_post),
                       ("ln_final", txt.ln_final)):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = cpu(ln.scale), cpu(ln.bias)
    for prefix, blocks in (("visual.transformer.resblocks", vis.blocks),
                           ("transformer.resblocks", txt.blocks)):
        for i, blk in enumerate(blocks):
            b = f"{prefix}.{i}"
            sd[f"{b}.attn.in_proj_weight"] = cpu(blk.attn.in_proj.kernel).T.contiguous()
            sd[f"{b}.attn.in_proj_bias"] = cpu(blk.attn.in_proj.bias)
            for name, dense in (("attn.out_proj", blk.attn.out_proj), ("mlp.c_fc", blk.mlp.c_fc),
                                ("mlp.c_proj", blk.mlp.c_proj)):
                sd[f"{b}.{name}.weight"] = cpu(dense.kernel).T.contiguous()
                sd[f"{b}.{name}.bias"] = cpu(dense.bias)
            for name, ln in (("ln_1", blk.ln_1), ("ln_2", blk.ln_2)):
                sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = cpu(ln.scale), cpu(ln.bias)
    return sd


def read_torch_state_dict(path: str) -> dict:
    """Read a .pt file (TorchScript archive or plain pickle) into float32
    numpy."""
    try:
        model = torch.jit.load(path, map_location="cpu")
        sd = model.state_dict()
    except Exception:  # noqa: BLE001 - not a TorchScript archive: a pickle
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
        # common wrappers: {'state_dict': ...} (mocov3/swin), {'model': ...}
        # (mae/declip)
        for wrap in ("state_dict", "model"):
            if isinstance(sd, dict) and wrap in sd and isinstance(sd[wrap], dict):
                sd = sd[wrap]
    return {k: v.float().numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def load_clip(model_name: str = "ViT-B/32", *, checkpoint_path: Optional[str] = None,
              cache_dir: str = "~/.cache/clip", allow_random: bool = True, seed: int = 0,
              spec_hint: Optional[CLIPSpec] = None, device=None) -> tuple:
    """(clip, spec) for ``model_name`` on ``device``.

    Resolution order, the reference's: ``"random"``, then an explicit
    ``checkpoint_path``, then the CLIP cache dir, then random weights (when
    ``allow_random``; logged loudly).  Random weights are drawn from a CPU
    generator seeded ``seed``, for ``spec_hint`` or else the name's ViT
    preset; a checkpoint's architecture comes from its keys."""
    from ..bridge import clip_from_jax

    def random():
        logging.warning("=> NO pretrained weights for %s; RANDOM-init CLIP (benchmarks/tests only)",
                        model_name)
        if spec_hint is not None:
            spec = spec_hint
        elif model_name.startswith("RN"):
            raise NotImplementedError(_RN_UNPORTED)
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
        logging.info("=> loading CLIP weights from %s", path)
        params, spec = state_dict_to_params(read_torch_state_dict(path))
        return clip_from_jax(params, spec, device=device), spec
    if not allow_random:
        raise FileNotFoundError(
            f"No checkpoint for {model_name!r} (tried {path!r}); downloads are disabled")
    return random()
