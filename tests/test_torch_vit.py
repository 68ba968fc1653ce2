"""The generic ViT (timm / DeiT / MAE / MoCo-v3) against pevit_tpu/models/vit.py,
fp32, at toy width (64 wide, 2 layers, 2 heads, 64 px):

* ``vit_forward_features`` at 1e-5 with the global pool on and off, the
  sin-cos positional embedding on and off, B/16 and B/32 patching;
* ``sincos_pos_embed_2d`` and the random init's tree equal the reference's;
* the timm converter, after ``normalize_vit_state_dict`` unwraps MAE's and
  MoCo-v3's layouts, gives the reference's tree bit for bit;
* a block given ``act`` never reaches the fused MLP (whose activation is
  QuickGELU), whatever ``use_fused_mlp`` says.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.core import layers as jl
from pevit_tpu.models import vit as jv
from pevit_tpu_torch import bridge
from pevit_tpu_torch.core import layers as tl
from pevit_tpu_torch.models import vit as pv

from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)

TOL = 1e-5
RES, WIDTH = 64, 64


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


def same_trees(got, want):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} * {scale}"


def spec_pair(**kw):
    js = jv.ViTSpec(input_resolution=RES, width=WIDTH, layers=2, heads=2, **kw)
    return js, pv.ViTSpec(**dataclasses.asdict(js))


@pytest.mark.parametrize("patch", [16, 32])
@pytest.mark.parametrize("sincos", [False, True])
@pytest.mark.parametrize("global_pool", [False, True])
def test_forward_features_match(global_pool, sincos, patch):
    js, ps = spec_pair(patch_size=patch, global_pool=global_pool, sincos_pos=sincos)
    params = jv.init_vit_params(jax.random.PRNGKey(patch + 2 * sincos), js)
    vit = pv.vit_from_params(np_tree(params), ps, device="cpu")
    x = np.random.default_rng(patch).standard_normal((3, RES, RES, 3)).astype(np.float32)
    want = jv.vit_forward_features(params, jnp.asarray(x), spec=js)
    got = pv.vit_forward_features(vit, torch.from_numpy(x), spec=ps)
    assert got.dtype == torch.float32
    close(got.detach().numpy(), want, "features")


def test_forward_with_head_and_bf16_images_match():
    """A classifier head, and bfloat16 images (the backbone casts them to
    float32, as the reference does)."""
    js, ps = spec_pair(patch_size=32, num_classes=5)
    params = jv.init_vit_params(jax.random.PRNGKey(4), js)
    vit = pv.vit_from_params(np_tree(params), ps, device="cpu")
    x = np.random.default_rng(4).standard_normal((2, RES, RES, 3)).astype(np.float32)
    want = jv.vit_forward(params, jnp.asarray(x, jnp.bfloat16), spec=js)
    got = pv.vit_forward(vit, torch.from_numpy(x).to(torch.bfloat16), spec=ps)
    assert got.shape == (2, 5)
    close(got.detach().numpy(), want, "logits")


@pytest.mark.parametrize("width,grid", [(64, 4), (768, 14), (32, 7)])
def test_sincos_pos_embed_equals_the_reference(width, grid):
    got = pv.sincos_pos_embed_2d(width, grid)
    want = jv.sincos_pos_embed_2d(width, grid)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("sincos,classes", [(False, 0), (True, 0), (False, 7)])
def test_init_tree_matches_the_reference(sincos, classes):
    js, ps = spec_pair(patch_size=16, sincos_pos=sincos, num_classes=classes)
    want = flat(np_tree(jv.init_vit_params(jax.random.PRNGKey(0), js)))
    got = flat(bridge.module_to_jax(pv.init_vit_params(torch.Generator().manual_seed(0), ps,
                                                       device="cpu")))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
    if sincos:
        assert np.array_equal(got["pos_embed"], want["pos_embed"])
    # the truncated normal's cut at 2 std (0.04)
    assert np.abs(got["blocks.attn.in_proj.kernel"]).max() <= 0.04
    assert np.all(got["blocks.ln_1.scale"] == 1) and not np.any(got["patch_embed.bias"])


def timm_state_dict(rng, *, layers=2, width=WIDTH, patch=16, grid=4, fc_norm=False,
                    classes=0):
    """A timm-layout ViT state dict from seeded tensors."""
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    sd = {"patch_embed.proj.weight": r(width, 3, patch, patch),
          "patch_embed.proj.bias": r(width), "cls_token": r(1, 1, width),
          "pos_embed": r(1, grid * grid + 1, width)}
    for i in range(layers):
        b = f"blocks.{i}"
        sd.update({f"{b}.norm1.weight": r(width), f"{b}.norm1.bias": r(width),
                   f"{b}.attn.qkv.weight": r(3 * width, width), f"{b}.attn.qkv.bias": r(3 * width),
                   f"{b}.attn.proj.weight": r(width, width), f"{b}.attn.proj.bias": r(width),
                   f"{b}.norm2.weight": r(width), f"{b}.norm2.bias": r(width),
                   f"{b}.mlp.fc1.weight": r(4 * width, width), f"{b}.mlp.fc1.bias": r(4 * width),
                   f"{b}.mlp.fc2.weight": r(width, 4 * width), f"{b}.mlp.fc2.bias": r(width)})
    norm = "fc_norm" if fc_norm else "norm"
    sd[f"{norm}.weight"], sd[f"{norm}.bias"] = r(width), r(width)
    if classes:
        sd["head.weight"], sd["head.bias"] = r(classes, width), r(classes)
    return sd


def wrap(sd, layout):
    """``sd`` as a published checkpoint of ``layout`` stores it."""
    if layout == "mae":
        return {"model": sd, "epoch": 1}
    if layout == "mocov3":
        out = {f"module.base_encoder.{k}": v for k, v in sd.items()}
        out.update({f"module.momentum_encoder.{k}": v for k, v in list(sd.items())[:3]})
        out["module.base_encoder.head.0.weight"] = np.zeros((4, 4), np.float32)
        return {"state_dict": out, "epoch": 1}
    return dict(sd)


@pytest.mark.parametrize("layout,fc_norm,classes,global_pool", [
    ("timm", False, 0, False), ("timm", False, 10, True), ("mae", True, 0, False),
    ("mocov3", False, 0, False)])
def test_timm_converter_is_bit_exact(layout, fc_norm, classes, global_pool):
    sd = timm_state_dict(np.random.default_rng(1), fc_norm=fc_norm, classes=classes)
    raw = wrap(sd, layout)
    jsd, psd = jv.normalize_vit_state_dict(raw), pv.normalize_vit_state_dict(raw)
    assert jsd.keys() == psd.keys() == sd.keys()
    want, jspec = jv.timm_state_dict_to_params(jsd, global_pool=global_pool)
    got, pspec = pv.timm_state_dict_to_params(psd, global_pool=global_pool)
    assert dataclasses.asdict(pspec) == dataclasses.asdict(jspec)
    assert pspec.global_pool is (global_pool or fc_norm)
    same_trees(got, np_tree(want))
    vit = pv.vit_from_params(got, pspec, device="cpu")
    same_trees(bridge.module_to_jax(vit), got)


def test_gelu_exact_matches():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32) * 4
    close(tl.gelu_exact(torch.from_numpy(x)).numpy(), jl.gelu_exact(jnp.asarray(x)), "gelu",
          tol=1e-6)


@pytest.mark.parametrize("use_fused_mlp", [True, False])
def test_a_block_with_act_never_reaches_the_fused_mlp(monkeypatch, use_fused_mlp):
    calls = []
    real = tl.fused_mlp_residual

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tl, "fused_mlp_residual", spy)
    blk = tl.ResidualAttentionBlock(WIDTH)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape) * 0.1)
    x = torch.randn(2, 5, WIDTH)
    y = tl.residual_attention_block(blk, x, n_head=2, use_fused_mlp=use_fused_mlp,
                                    act=tl.gelu_exact)
    assert not calls
    # the erf GELU's block, not QuickGELU's
    h = x + tl.multi_head_attention(blk.attn, tl.layer_norm(x, blk.ln_1.scale, blk.ln_1.bias),
                                    n_head=2)
    m = tl.mlp(blk.mlp, tl.layer_norm(h, blk.ln_2.scale, blk.ln_2.bias), act=tl.gelu_exact)
    torch.testing.assert_close(y, h + m, rtol=0, atol=0)
    tl.residual_attention_block(blk, x, n_head=2, use_fused_mlp=use_fused_mlp)
    assert len(calls) == int(use_fused_mlp)
    # and the whole ViT never does
    _, ps = spec_pair(patch_size=32)
    pv.vit_forward_features(pv.init_vit_params(torch.Generator().manual_seed(0), ps,
                                               device="cpu"), torch.randn(1, RES, RES, 3), spec=ps)
    assert len(calls) == int(use_fused_mlp)
