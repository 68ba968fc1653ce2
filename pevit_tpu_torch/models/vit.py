"""The generic (timm-style) ViT backbone: supervised ``vit_base_patch{16,32}_224``
and ``deit_base_patch16_224``, MAE and MoCo-v3.

Counterpart of ``pevit_tpu/models/vit.py``.  A pre-LN ViT with the exact
(erf) GELU: its blocks are the CLIP blocks of ``core.layers`` given
``act=gelu_exact``, so their mask-free attention goes through the attention
kernel and their MLP always takes the unfused route (the fused kernel
computes QuickGELU only).  MAE's global pool (the mean over the patch
tokens, then ``fc_norm``) replaces the CLS token where ``global_pool`` is
set; MoCo-v3 uses a fixed 2D sin-cos positional embedding.

LayerNorm eps is 1e-5, the reference's (``pevit_tpu`` passes none), not
timm's 1e-6.  The parameter tree is the reference's: ``patch_embed``
(kernel ``(p*p*3, width)`` and bias), ``cls_token``, ``pos_embed``,
``blocks`` (one module a layer here, stacked in the reference), ``norm``,
and ``head`` when the spec has classes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core.clip import patchify_images
from ..core.layers import Dense, LayerNorm, ResidualAttentionBlock, gelu_exact, layer_norm
from ..core.layers import residual_attention_block


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    input_resolution: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    num_classes: int = 0
    global_pool: bool = False  # MAE: the mean over patch tokens + fc_norm
    sincos_pos: bool = False   # MoCo-v3: fixed 2D sin-cos positional embedding

    @property
    def grid(self) -> int:
        return self.input_resolution // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1


def sincos_pos_embed_2d(width: int, grid: int, cls_token: bool = True) -> np.ndarray:
    """Fixed 2D sine-cosine positional embedding (the MoCo-v3 / MAE scheme),
    computed in float64 and returned as float32."""
    assert width % 4 == 0
    dim_q = width // 4
    omega = 1.0 / (10000 ** (np.arange(dim_q, dtype=np.float64) / dim_q))
    coords = np.arange(grid, dtype=np.float64)
    gy, gx = np.meshgrid(coords, coords, indexing="ij")
    out = []
    for g in (gy, gx):
        ang = g.reshape(-1, 1) * omega[None, :]
        out.extend([np.sin(ang), np.cos(ang)])
    pos = np.concatenate(out, axis=1)  # (grid*grid, width)
    if cls_token:
        pos = np.concatenate([np.zeros((1, width)), pos], axis=0)
    return pos.astype(np.float32)


class ViT(nn.Module):
    """Parameters of the generic ViT."""

    def __init__(self, spec: ViTSpec):
        super().__init__()
        w = spec.width
        self.patch_embed = Dense(spec.patch_size * spec.patch_size * 3, w)
        self.cls_token = nn.Parameter(torch.zeros(w))
        self.pos_embed = nn.Parameter(torch.zeros(spec.seq_len, w))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(w) for _ in range(spec.layers))
        self.norm = LayerNorm(w)
        if spec.num_classes:
            self.head = Dense(w, spec.num_classes)


def init_vit_params(generator: torch.Generator, spec: ViTSpec, *, device=None) -> ViT:
    """Random weights with the reference's distributions: truncated normal
    (std 0.02, cut at 2 std) for every kernel, the class token and the
    learned positional embedding; biases zero, LayerNorms the identity."""
    from ..utils.device import resolve_device

    vit = ViT(spec)

    def trunc(p: nn.Parameter) -> None:
        t = torch.empty(p.shape)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        p.copy_(0.02 * t)

    with torch.no_grad():
        if spec.sincos_pos:
            vit.pos_embed.copy_(torch.from_numpy(sincos_pos_embed_2d(spec.width, spec.grid)))
        else:
            trunc(vit.pos_embed)
        for blk in vit.blocks:
            for dense in (blk.attn.in_proj, blk.attn.out_proj, blk.mlp.c_fc, blk.mlp.c_proj):
                trunc(dense.kernel)
        trunc(vit.patch_embed.kernel)
        trunc(vit.cls_token)
        if spec.num_classes:
            trunc(vit.head.kernel)
    return vit.to(resolve_device(device))


def vit_forward_features(vit: ViT, x: torch.Tensor, *, spec: ViTSpec,
                         compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) float images -> (B, width) pooled features, in
    ``compute_dtype`` (float32 by default, whatever the images' dtype, as
    the reference casts them)."""
    B = x.shape[0]
    dt = compute_dtype
    x = patchify_images(x.to(dt), spec.patch_size)
    x = x @ vit.patch_embed.kernel.to(dt) + vit.patch_embed.bias.to(dt)
    cls = vit.cls_token.to(dt).expand(B, 1, spec.width)
    x = torch.cat([cls, x], dim=1) + vit.pos_embed.to(dt)
    for blk in vit.blocks:
        x = residual_attention_block(blk, x, n_head=spec.heads, act=gelu_exact)
    if spec.global_pool:
        # MAE: the mean over the patch tokens, then fc_norm (mae.py:30-38)
        return layer_norm(x[:, 1:, :].mean(dim=1), vit.norm.scale, vit.norm.bias)
    return layer_norm(x, vit.norm.scale, vit.norm.bias)[:, 0]


def vit_forward(vit: ViT, x: torch.Tensor, *, spec: ViTSpec,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pooled features, through ``head`` where the model has one."""
    feats = vit_forward_features(vit, x, spec=spec, compute_dtype=compute_dtype)
    if spec.num_classes:
        return feats @ vit.head.kernel.to(feats.dtype) + vit.head.bias.to(feats.dtype)
    return feats


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _stack_timm_blocks(sd: dict, n_layers: int) -> dict:
    def stacked(key, transpose=False):
        arrs = [np.asarray(sd[f"blocks.{i}.{key}"], np.float32) for i in range(n_layers)]
        return np.stack([a.T if transpose else a for a in arrs])

    return {
        "attn": {
            "in_proj": {"kernel": stacked("attn.qkv.weight", True), "bias": stacked("attn.qkv.bias")},
            "out_proj": {"kernel": stacked("attn.proj.weight", True), "bias": stacked("attn.proj.bias")},
        },
        "mlp": {
            "c_fc": {"kernel": stacked("mlp.fc1.weight", True), "bias": stacked("mlp.fc1.bias")},
            "c_proj": {"kernel": stacked("mlp.fc2.weight", True), "bias": stacked("mlp.fc2.bias")},
        },
        "ln_1": {"scale": stacked("norm1.weight"), "bias": stacked("norm1.bias")},
        "ln_2": {"scale": stacked("norm2.weight"), "bias": stacked("norm2.bias")},
    }


def timm_state_dict_to_params(sd: dict, *, global_pool: bool = False) -> tuple:
    """A timm ViT state dict (``normalize_vit_state_dict`` has unwrapped MAE's
    and MoCo-v3's nesting) -> (the reference's tree as float32 numpy, spec).
    A checkpoint with ``fc_norm`` is a global-pool (MAE) model."""
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    n_layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    conv = sd["patch_embed.proj.weight"]  # (w, 3, p, p)
    w, _, p, _ = conv.shape
    n_pos = sd["pos_embed"].shape[-2]
    grid = int(round((n_pos - 1) ** 0.5))
    norm_key = "fc_norm" if "fc_norm.weight" in sd else "norm"
    spec = ViTSpec(
        input_resolution=p * grid,
        patch_size=p,
        width=w,
        layers=n_layers,
        heads=w // 64,
        num_classes=sd["head.weight"].shape[0] if "head.weight" in sd else 0,
        global_pool=global_pool or norm_key == "fc_norm",
    )
    params = {
        "patch_embed": {
            "kernel": conv.transpose(2, 3, 1, 0).reshape(p * p * 3, w),
            "bias": sd.get("patch_embed.proj.bias", np.zeros(w, np.float32)),
        },
        "cls_token": sd["cls_token"].reshape(-1),
        "pos_embed": sd["pos_embed"].reshape(n_pos, w),
        "blocks": _stack_timm_blocks(sd, n_layers),
        "norm": {"scale": sd[f"{norm_key}.weight"], "bias": sd[f"{norm_key}.bias"]},
    }
    if "head.weight" in sd:
        params["head"] = {
            "kernel": sd["head.weight"].T,
            "bias": sd.get("head.bias", np.zeros(spec.num_classes, np.float32)),
        }
    return params, spec


def normalize_vit_state_dict(obj: dict) -> dict:
    """Unwrap MAE's ``model`` and MoCo-v3's ``state_dict`` nesting and strip
    MoCo-v3's ``module.base_encoder.`` style prefixes (mocov3.py:148-160);
    MoCo's contrastive head (``head.*`` other than weight and bias) is
    dropped."""
    sd = obj
    if "model" in sd and isinstance(sd["model"], dict):  # MAE (mae.py:90)
        sd = sd["model"]
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):  # MoCo-v3
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        for prefix in ("module.base_encoder.", "module.momentum_encoder.", "base_encoder.", "module."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        if k.startswith("head.") and k not in ("head.weight", "head.bias"):
            continue
        out[k] = v
    return out


def vit_from_params(params_np: dict, spec: ViTSpec, *, device=None) -> ViT:
    """The reference's ViT tree as numpy -> the port's ``ViT`` on ``device``."""
    from ..bridge import module_from_jax

    return module_from_jax(params_np, ViT(spec), device=device)
