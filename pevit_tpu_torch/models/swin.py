"""The Swin Transformer classifier and the CLIP-Swin model (a Swin visual
tower beside a CLIP text tower).

Counterpart of ``pevit_tpu/models/swin.py`` (reference models/cls_swin.py
and models/clip_swin.py).  Window attention and the MLP are plain PyTorch,
as they are plain XLA in the reference: the head dimension is 32 and every
attention carries the relative-position bias (and, in shifted blocks, the
window mask), which the attention kernel takes neither of.  The attention
is written in the reference's order of operations (float32 logits, the
bias, then the mask, then the softmax), not through a fused attention.

Kept from the reference:

* the window and the shift are clamped where a stage's resolution is at
  most the window: the whole stage is one window and no block shifts
  (cls_swin.py:198-201), the last stage of every standard Swin;
* the shifted-window mask is built in the rolled frame and not rolled
  (cls_swin.py:216-232);
* stochastic depth on both residual branches with the per-block rate
  ``linspace(0, DROP_PATH_RATE, sum(depths))`` (cls_swin.py:533), optional
  layer-scale ``gamma`` (init 1e-4), dropout at DROP_RATE, the absolute
  position embedding (APE), the patch norm and the qkv bias as options.

Train-time randomness (drop path, dropout) draws from an explicit
``torch.Generator``; train mode with a non-zero rate and no generator
raises, as the reference raises without an rng.

A batch of T trials runs on the trials' images folded, (T*B, ...): a frozen
tower shared, a trained one stacked (every parameter (T, ...),
``core.trial_axis``), trial t's rows through trial t's weights and its
relative-position bias.  The generator is then one per trial, and each
draw gives trial t's rows from trial t's generator, the shape a lone trial
draws, in a lone trial's order, so that a batch draws what each trial
draws alone.

The parameter tree is the reference's: ``patch_embed`` (kernel ``(p*p*3,
C)``, bias), ``patch_norm``, ``absolute_pos_embed``, ``stages`` (a list of
``{"blocks": [...], "downsample"}``), ``norm`` and ``head``; each block
holds ``norm1``, ``qkv``, ``proj``, ``rel_bias``, ``norm2``, ``fc1``,
``fc2`` and ``gamma``.  The relative-position index and the window masks
are non-persistent buffers of each stage, made from the spec.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core import trial_axis
from ..core.clip import CLIPSpec, TextSpec, init_clip_params
from ..core.layers import LayerNorm, ListModule, ResidualAttentionBlock, gelu_exact, layer_norm


@dataclasses.dataclass(frozen=True)
class SwinSpec:
    img_size: int = 224
    patch_size: int = 4
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    num_classes: int = 0
    drop_path_rate: float = 0.0  # stochastic depth (cls_swin.py:209,280-281)
    layer_scale: bool = False    # learnable gamma, init 1e-4 (cls_swin.py:237-240)
    drop_rate: float = 0.0       # pos_drop, proj_drop, the MLP's two drops
    ape: bool = False            # absolute position embedding (cls_swin.py:524-528)
    patch_norm: bool = True      # LayerNorm after the patch embedding
    qkv_bias: bool = True
    qk_scale: Optional[float] = None  # None -> head_dim ** -0.5

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)

    def stage_res(self, i: int) -> int:
        return self.img_size // self.patch_size // (2 ** i)

    def stage_window(self, i: int) -> int:
        """The stage's window, clamped to its resolution."""
        return min(self.window_size, self.stage_res(i))

    def block_shift(self, i: int, b: int) -> int:
        """Block b of stage i shifts by half a window on odd b, unless the
        stage is one window."""
        return 0 if (b % 2 == 0 or self.stage_res(i) <= self.window_size) else self.window_size // 2


def swin_tiny(num_classes: int = 0, img_size: int = 224) -> SwinSpec:
    return SwinSpec(img_size=img_size, num_classes=num_classes)


def swin_base(num_classes: int = 0, img_size: int = 224) -> SwinSpec:
    return SwinSpec(img_size=img_size, embed_dim=128, depths=(2, 2, 18, 2),
                    num_heads=(4, 8, 16, 32), num_classes=num_classes)


def _relative_index(window: int) -> np.ndarray:
    """(win^2, win^2) indices into the (2w-1)^2 relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, n, n)
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int32)


def _attn_mask(res: int, window: int, shift: int) -> np.ndarray:
    """Additive mask (nW, win^2, win^2) of shifted windows, the region map
    built in the rolled frame and partitioned as it is (cls_swin.py:216-232)."""
    if shift == 0:
        n_w = (res // window) ** 2
        return np.zeros((n_w, window * window, window * window), np.float32)
    img = np.zeros((res, res), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = (img.reshape(res // window, window, res // window, window)
            .transpose(0, 2, 1, 3).reshape(-1, window * window))
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """``kernel`` (in, out) and, where ``bias``, ``bias`` (out,)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        if bias:
            self.bias = nn.Parameter(torch.zeros(d_out))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, spec: SwinSpec):
        super().__init__()
        hidden = int(dim * spec.mlp_ratio)
        self.norm1 = LayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim, bias=spec.qkv_bias)
        self.proj = Linear(dim, dim)
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.norm2 = LayerNorm(dim)
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        if spec.layer_scale:
            self.gamma = nn.Parameter(torch.full((dim,), 1e-4))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)


class SwinStage(nn.Module):
    """A stage's blocks and its patch merging, with its relative-position
    index and its shifted-window mask as non-persistent buffers."""

    def __init__(self, spec: SwinSpec, i: int):
        super().__init__()
        dim, win, res = spec.stage_dim(i), spec.stage_window(i), spec.stage_res(i)
        self.blocks = ListModule(SwinBlock(dim, spec.num_heads[i], win, spec)
                                 for _ in range(spec.depths[i]))
        if i < spec.num_stages - 1:
            self.downsample = PatchMerging(dim)
        self.register_buffer("rel_index", torch.from_numpy(
            _relative_index(win).reshape(-1).astype(np.int64)), persistent=False)
        shift = max(spec.block_shift(i, b) for b in range(spec.depths[i]))
        self.register_buffer("attn_mask", torch.from_numpy(_attn_mask(res, win, shift)),
                             persistent=False)


class Swin(nn.Module):
    """Parameters of the Swin Transformer (the reference's tree)."""

    def __init__(self, spec: SwinSpec):
        super().__init__()
        p, c = spec.patch_size, spec.embed_dim
        self.patch_embed = Linear(p * p * 3, c)
        if spec.patch_norm:
            self.patch_norm = LayerNorm(c)
        if spec.ape:
            g = spec.img_size // p
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, g * g, c))
        self.stages = ListModule(SwinStage(spec, i) for i in range(spec.num_stages))
        final = spec.stage_dim(spec.num_stages - 1)
        self.norm = LayerNorm(final)
        if spec.num_classes:
            self.head = Linear(final, spec.num_classes)


def init_swin_params(generator: torch.Generator, spec: SwinSpec, *, device=None) -> Swin:
    """Random weights with the reference's distributions: truncated normal
    (std 0.02, cut at 2 std) for every kernel, the relative-position tables
    and the APE; biases zero, LayerNorms the identity, gamma 1e-4."""
    from ..utils.device import resolve_device

    swin = Swin(spec)

    def trunc(p: nn.Parameter) -> None:
        t = torch.empty(p.shape)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        p.copy_(0.02 * t)

    with torch.no_grad():
        trunc(swin.patch_embed.kernel)
        if spec.ape:
            trunc(swin.absolute_pos_embed)
        for stage in swin.stages:
            for blk in stage.blocks:
                for p in (blk.qkv.kernel, blk.proj.kernel, blk.rel_bias, blk.fc1.kernel,
                          blk.fc2.kernel):
                    trunc(p)
            if hasattr(stage, "downsample"):
                trunc(stage.downsample.reduction.kernel)
        if spec.num_classes:
            trunc(swin.head.kernel)
    return swin.to(resolve_device(device))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _gens(generator) -> list:
    """A forward's generator as a list: one per trial of a batch, or the
    lone one."""
    if generator is None or isinstance(generator, torch.Generator):
        return [generator]
    return list(generator)


def _drop_path(h: torch.Tensor, p: float, generator) -> torch.Tensor:
    """Per-sample stochastic depth (cls_swin.py:87-104): each sample's branch
    is kept with probability 1 - p and the kept ones scaled by 1 / (1 - p).
    ``generator`` is one generator, or one per trial of h's folded rows."""
    if p <= 0.0:
        return h
    keep = 1.0 - p
    shape = (h.shape[0],) + (1,) * (h.dim() - 1)
    mask = trial_axis.rand_rows(shape, _gens(generator), h.device) < keep
    return h * mask.to(h.dtype) / torch.tensor(keep, dtype=h.dtype, device=h.device)


def _dropout(h: torch.Tensor, p: float, generator) -> torch.Tensor:
    """Elementwise inverted dropout; ``generator`` as in :func:`_drop_path`."""
    if p <= 0.0:
        return h
    keep = 1.0 - p
    mask = trial_axis.rand_rows(h.shape, _gens(generator), h.device) < keep
    return h * mask.to(h.dtype) / torch.tensor(keep, dtype=h.dtype, device=h.device)


def _lin(x: torch.Tensor, p: Linear) -> torch.Tensor:
    y = trial_axis.matmul(x, p.kernel.to(x.dtype))
    bias = getattr(p, "bias", None)
    return y if bias is None else trial_axis.add(y, bias.to(x.dtype), 1)


def _window_attention(bp: SwinBlock, x: torch.Tensor, *, res: int, window: int, shift: int,
                      n_head: int, rel_index: torch.Tensor, mask: Optional[torch.Tensor],
                      qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x: (B, res, res, C) -> the attention branch (the caller adds the
    residual), in the reference's order (``pevit_tpu/models/swin.py:192-236``)."""
    B, _, _, C = x.shape
    hd = C // n_head
    n = window * window
    nw = res // window
    h = layer_norm(x, bp.norm1.scale, bp.norm1.bias)
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    h = (h.reshape(B, nw, window, nw, window, C).permute(0, 1, 3, 2, 4, 5)
         .reshape(B * nw * nw, n, C))
    qkv = _lin(h, bp.qkv).reshape(-1, n, 3, n_head, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B*nW, H, n, hd)
    q = q * (hd ** -0.5 if qk_scale is None else qk_scale)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    table = bp.rel_bias[..., rel_index, :]  # (n*n, H), or (T, n*n, H) stacked
    rel = table.reshape(*table.shape[:-2], n, n, n_head).movedim(-1, -3)
    logits = trial_axis.add(logits, rel, 3)
    if mask is not None:
        logits = logits + mask[None].expand(B, -1, -1, -1).reshape(-1, 1, n, n)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(attn, v).permute(0, 2, 1, 3).reshape(-1, n, C)
    out = _lin(out, bp.proj)
    if drop_rate > 0.0:
        out = _dropout(out, drop_rate, generator)  # proj_drop (cls_swin.py:170)
    out = (out.reshape(B, nw, nw, window, window, C).permute(0, 1, 3, 2, 4, 5)
           .reshape(B, res, res, C))
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out


def swin_forward_features(swin: Swin, x: torch.Tensor, *, spec: SwinSpec,
                          compute_dtype: torch.dtype = torch.float32, train: bool = False,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, H, W, 3) float images -> (B, final_dim) pooled features.

    ``train=True`` turns on stochastic depth and dropout where their rates
    are non-zero; they draw from ``generator`` (on x's device), or, for a
    batch of trials whose images x folds, from a sequence of one generator
    per trial."""
    use_dp = train and spec.drop_path_rate > 0.0
    do_rate = spec.drop_rate if train else 0.0
    if (use_dp or do_rate > 0.0) and generator is None:
        raise ValueError(f"DROP_PATH_RATE={spec.drop_path_rate}/DROP_RATE={spec.drop_rate} "
                         "in train mode requires a generator")
    dpr = np.linspace(0.0, spec.drop_path_rate, sum(spec.depths))  # cls_swin.py:533
    dt = compute_dtype
    B = x.shape[0]
    p = spec.patch_size
    g = spec.img_size // p
    x = x.to(dt).reshape(B, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, p * p * 3)
    x = _lin(x, swin.patch_embed)
    if spec.patch_norm:
        x = layer_norm(x, swin.patch_norm.scale, swin.patch_norm.bias)
    if spec.ape:  # (1, L, C), or (T, 1, L, C) stacked
        x = trial_axis.add(x, swin.absolute_pos_embed.select(-3, 0).to(x.dtype), 2)
    if do_rate > 0.0:
        x = _dropout(x, do_rate, generator)  # pos_drop (cls_swin.py:530)
    x = x.reshape(B, g, g, spec.embed_dim)

    blk_idx = 0
    for s, stage in enumerate(swin.stages):
        res, win = spec.stage_res(s), spec.stage_window(s)
        for b, bp in enumerate(stage.blocks):
            shift = spec.block_shift(s, b)
            attn_out = _window_attention(
                bp, x, res=res, window=win, shift=shift, n_head=spec.num_heads[s],
                rel_index=stage.rel_index, mask=stage.attn_mask if shift else None,
                qk_scale=spec.qk_scale, drop_rate=do_rate, generator=generator)
            gamma = getattr(bp, "gamma", None)
            if gamma is not None:
                attn_out = trial_axis.mul(attn_out, gamma.to(attn_out.dtype), 1)
            p_blk = float(dpr[blk_idx]) if use_dp else 0.0
            if p_blk > 0.0:
                attn_out = _drop_path(attn_out, p_blk, generator)
            x = x + attn_out
            h = layer_norm(x, bp.norm2.scale, bp.norm2.bias)
            h = gelu_exact(_lin(h, bp.fc1))
            if do_rate > 0.0:
                h = _dropout(h, do_rate, generator)  # the MLP's first drop
            h = _lin(h, bp.fc2)
            if do_rate > 0.0:
                h = _dropout(h, do_rate, generator)  # and its second
            if gamma is not None:
                h = trial_axis.mul(h, gamma.to(h.dtype), 1)
            if p_blk > 0.0:
                h = _drop_path(h, p_blk, generator)
            x = x + h
            blk_idx += 1
        if hasattr(stage, "downsample"):
            # patch merging: the 2x2 neighbourhood concatenated in official
            # Swin's order [r-even/c-even, r-odd/c-even, r-even/c-odd,
            # r-odd/c-odd], then norm and the 4C -> 2C reduction
            Bc, H, W, C = x.shape
            x = x.reshape(Bc, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
            x = x.reshape(Bc, H // 2, W // 2, 4 * C)
            ds = stage.downsample
            x = layer_norm(x, ds.norm.scale, ds.norm.bias)
            x = _lin(x, ds.reduction)
    x = x.reshape(B, -1, x.shape[-1])
    x = layer_norm(x, swin.norm.scale, swin.norm.bias)
    return x.mean(dim=1)


def swin_forward(swin: Swin, x: torch.Tensor, *, spec: SwinSpec,
                 compute_dtype: torch.dtype = torch.float32, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Pooled features, through ``head`` where the model has one."""
    feats = swin_forward_features(swin, x, spec=spec, compute_dtype=compute_dtype, train=train,
                                  generator=generator)
    return _lin(feats, swin.head) if spec.num_classes else feats


# ---------------------------------------------------------------------------
# CLIP-Swin
# ---------------------------------------------------------------------------

class ClipSwinText(nn.Module):
    """CLIP-Swin's text tower: CLIP's, with the projection outside it."""

    def __init__(self, t: TextSpec):
        super().__init__()
        self.token_embedding = nn.Parameter(torch.zeros(t.vocab_size, t.width))
        self.positional_embedding = nn.Parameter(torch.zeros(t.context_length, t.width))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(t.width) for _ in range(t.layers))
        self.ln_final = LayerNorm(t.width)


class ClipSwin(nn.Module):
    """CLIP-Swin's parameters (clip_swin.py:153-260): ``visual`` (a Swin),
    ``vision_projection``, ``text``, ``text_projection`` and ``logit_scale``."""

    def __init__(self, sspec: SwinSpec, cspec: CLIPSpec):
        super().__init__()
        self.visual = Swin(sspec)
        self.vision_projection = nn.Parameter(
            torch.zeros(sspec.stage_dim(sspec.num_stages - 1), cspec.embed_dim))
        self.text = ClipSwinText(cspec.text)
        self.text_projection = nn.Parameter(torch.zeros(cspec.text.width, cspec.embed_dim))
        self.logit_scale = nn.Parameter(torch.zeros(()))


def init_clip_swin_params(generator: torch.Generator, sspec: SwinSpec, cspec: CLIPSpec, *,
                          device=None) -> ClipSwin:
    """Random CLIP-Swin: the visual tower as :func:`init_swin_params`, the
    vision projection N(0, 0.02), the text tower, its projection and the
    logit scale as a CLIP's (``init_clip_params``)."""
    from ..utils.device import resolve_device

    model = ClipSwin(sspec, cspec)
    model.visual = init_swin_params(generator, sspec, device="cpu")
    clip = init_clip_params(generator, cspec, device="cpu")
    with torch.no_grad():
        model.vision_projection.copy_(
            0.02 * torch.randn(model.vision_projection.shape, generator=generator))
        sd = {k: v for k, v in clip.text.state_dict().items() if k != "text_projection"}
        model.text.load_state_dict(sd)
        model.text_projection.copy_(clip.text.text_projection)
        model.logit_scale.copy_(clip.logit_scale)
    return model.to(resolve_device(device))


def clip_swin_text_view(model: ClipSwin):
    """The model's text tower in the shape ``core.clip.encode_text`` reads
    (``clip.text`` with its ``text_projection``)."""
    from types import SimpleNamespace

    t = model.text
    return SimpleNamespace(text=SimpleNamespace(
        token_embedding=t.token_embedding, positional_embedding=t.positional_embedding,
        blocks=t.blocks, ln_final=t.ln_final, text_projection=model.text_projection))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def swin_state_dict_to_params(sd: dict) -> tuple:
    """An official Swin checkpoint (microsoft/Swin-Transformer key layout) ->
    (the reference's tree as float32 numpy, spec); qkv bias, APE, patch
    norm, layer scale and the head are read off the keys present."""
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items() if hasattr(v, "shape")}
    conv = sd["patch_embed.proj.weight"]  # (C, 3, p, p)
    embed_dim, _, p, _ = conv.shape
    n_stages = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    depths, heads = [], []
    for s in range(n_stages):
        blocks = {int(k.split(".")[3]) for k in sd if k.startswith(f"layers.{s}.blocks.")}
        depths.append(len(blocks))
        heads.append(sd[f"layers.{s}.blocks.0.attn.relative_position_bias_table"].shape[1])
    table = sd["layers.0.blocks.0.attn.relative_position_bias_table"]
    spec = SwinSpec(
        patch_size=p,
        embed_dim=embed_dim,
        depths=tuple(depths),
        num_heads=tuple(heads),
        window_size=(int(round(table.shape[0] ** 0.5)) + 1) // 2,
        num_classes=sd["head.weight"].shape[0] if "head.weight" in sd else 0,
        layer_scale="layers.0.blocks.0.gamma" in sd,
        ape="absolute_pos_embed" in sd,
        patch_norm="patch_embed.norm.weight" in sd,
        qkv_bias="layers.0.blocks.0.attn.qkv.bias" in sd,
    )

    def lin(prefix, bias=True):
        out = {"kernel": sd[f"{prefix}.weight"].T}
        if bias and f"{prefix}.bias" in sd:
            out["bias"] = sd[f"{prefix}.bias"]
        return out

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    params = {
        "patch_embed": {"kernel": conv.transpose(2, 3, 1, 0).reshape(p * p * 3, embed_dim),
                        "bias": sd["patch_embed.proj.bias"]},
        "stages": [],
        "norm": ln("norm"),
    }
    if spec.patch_norm:
        params["patch_norm"] = ln("patch_embed.norm")
    if spec.ape:
        params["absolute_pos_embed"] = sd["absolute_pos_embed"].reshape(1, -1, embed_dim)
    for s in range(n_stages):
        blocks = []
        for b in range(depths[s]):
            pre = f"layers.{s}.blocks.{b}"
            blocks.append({
                "norm1": ln(f"{pre}.norm1"),
                "qkv": lin(f"{pre}.attn.qkv"),
                "proj": lin(f"{pre}.attn.proj"),
                "rel_bias": sd[f"{pre}.attn.relative_position_bias_table"],
                "norm2": ln(f"{pre}.norm2"),
                "fc1": lin(f"{pre}.mlp.fc1"),
                "fc2": lin(f"{pre}.mlp.fc2"),
            })
            if f"{pre}.gamma" in sd:
                blocks[-1]["gamma"] = sd[f"{pre}.gamma"]
        stage = {"blocks": blocks}
        if f"layers.{s}.downsample.reduction.weight" in sd:
            stage["downsample"] = {"norm": ln(f"layers.{s}.downsample.norm"),
                                   "reduction": lin(f"layers.{s}.downsample.reduction",
                                                    bias=False)}
        params["stages"].append(stage)
    if "head.weight" in sd:
        params["head"] = lin("head")
    return params, spec


def clip_swin_state_dict_to_params(sd: dict) -> tuple:
    """A CLIP-Swin checkpoint (clip_swin.py:153-260 layout) -> (the
    reference's tree as float32 numpy, SwinSpec, CLIPSpec): ``visual.*`` in
    the official Swin layout, ``text.*`` (token and positional embeddings,
    ``resblocks``, ``ln_final``), the bare ``text_projection`` and
    ``vision_projection`` matrices and ``logit_scale``; other keys are
    ignored, as the reference loads with strict=False."""
    from ..ckpt.torch_loader import _ln, _stack_blocks

    sd = {k: np.asarray(v, np.float32) for k, v in sd.items() if hasattr(v, "shape")}
    visual_params, sspec = swin_state_dict_to_params(
        {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")})
    tsub = {k[len("text."):]: v for k, v in sd.items() if k.startswith("text.")}
    n_layers = len({k.split(".")[1] for k in tsub if k.startswith("resblocks.")})
    twidth = tsub["token_embedding.weight"].shape[1]
    embed_dim = sd["text_projection"].shape[1]
    cspec = CLIPSpec(
        embed_dim=embed_dim,
        text=TextSpec(context_length=tsub["positional_embedding"].shape[0],
                      vocab_size=tsub["token_embedding.weight"].shape[0], width=twidth,
                      heads=max(1, twidth // 64), layers=n_layers, output_dim=embed_dim),
    )
    params = {
        "visual": visual_params,
        "vision_projection": sd["vision_projection"],
        "text": {
            "token_embedding": tsub["token_embedding.weight"],
            "positional_embedding": tsub["positional_embedding"],
            "blocks": _stack_blocks(tsub, "resblocks", n_layers),
            "ln_final": _ln(tsub, "ln_final"),
        },
        "text_projection": sd["text_projection"],
        "logit_scale": sd["logit_scale"].reshape(()),
    }
    return params, sspec, cspec


def swin_from_params(params_np: dict, spec: SwinSpec, *, device=None) -> Swin:
    """The reference's Swin tree as numpy -> the port's ``Swin`` on ``device``."""
    from ..bridge import module_from_jax

    return module_from_jax(params_np, Swin(spec), device=device)


def clip_swin_from_params(params_np: dict, sspec: SwinSpec, cspec: CLIPSpec, *,
                          device=None) -> ClipSwin:
    """The reference's CLIP-Swin tree as numpy -> the port's ``ClipSwin``."""
    from ..bridge import module_from_jax

    return module_from_jax(params_np, ClipSwin(sspec, cspec), device=device)
