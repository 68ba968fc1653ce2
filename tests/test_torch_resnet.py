"""The ModifiedResNet CLIP towers against pevit_tpu/core/resnet.py and the RN
branch of pevit_tpu/ckpt/torch_loader.py, fp32, at toy width (width 8,
blocks (1, 2, 1, 1) or (2, 1, 1, 1), 64 or 96 px), with random BatchNorm
running statistics so that the folded eval-mode BatchNorm is live:

* ``encode_image`` through the RN dispatch at 1e-5;
* the converter with spec inference, bit for bit, on an OpenAI-layout
  state dict that the port's ``clip_to_state_dict`` writes, and
  ``load_clip`` from that file in both packages;
* the presets, the random init's tree and ``load_clip``'s random RN branch;
* PEFT hooks on an RN tower raise, as in the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.ckpt import torch_loader as jl
from pevit_tpu.core import clip as jc
from pevit_tpu.core import resnet as jr
from pevit_tpu_torch import bridge
from pevit_tpu_torch.ckpt import torch_loader as pl
from pevit_tpu_torch.core import clip as pc
from pevit_tpu_torch.core import resnet as pr
from pevit_tpu_torch.peft import PeftConfig, make_hooks

from .test_torch_vit import close, flat, np_tree, same_trees

TEXT = dict(context_length=8, vocab_size=64, width=32, heads=2, layers=1, output_dim=32)
RN_CASES = {"64px": (64, 8, (1, 2, 1, 1), 32), "96px": (96, 8, (2, 1, 1, 1), 24)}


def spec_pair(case):
    rs = jr.ResNetSpec(*RN_CASES[case])
    js = jc.CLIPSpec(embed_dim=rs.output_dim, text=jc.TextSpec(**{**TEXT, "output_dim": rs.output_dim}),
                     vision_rn=rs)
    ps = pc.CLIPSpec(embed_dim=rs.output_dim, text=pc.TextSpec(**dataclasses.asdict(js.text)),
                     vision_rn=pr.ResNetSpec(**dataclasses.asdict(rs)))
    return js, ps


def randomize_bn(tree, rng):
    """Random BatchNorm affine and running statistics, in place."""
    for v in tree.values():
        if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
            v["scale"] = (1 + 0.1 * rng.standard_normal(v["scale"].shape)).astype(np.float32)
            v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
            v["mean"] = (0.2 * rng.standard_normal(v["mean"].shape)).astype(np.float32)
            v["var"] = (rng.random(v["var"].shape) + 0.5).astype(np.float32)
        elif isinstance(v, dict):
            randomize_bn(v, rng)


def rn_params(case, seed=0):
    """(JAX spec, port spec, the reference's RN CLIP tree as numpy with live
    BatchNorms, the port's CLIP loaded from it)."""
    js, ps = spec_pair(case)
    params = jax.tree.map(np.array, jc.init_clip_params(jax.random.PRNGKey(seed), js))
    randomize_bn(params["visual"], np.random.default_rng(seed))
    return js, ps, params, bridge.clip_from_jax(params, ps, device="cpu")


@pytest.mark.parametrize("case", sorted(RN_CASES))
def test_encode_image_rn_matches(case):
    js, ps, params, clip = rn_params(case)
    res = js.vision_rn.input_resolution
    x = np.random.default_rng(1).standard_normal((3, res, res, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jc.encode_image(p, x, spec=js))(params, jnp.asarray(x))
    got = pc.encode_image(clip, torch.from_numpy(x), spec=ps)
    assert got.shape == (3, js.vision_rn.output_dim)
    close(got.detach().numpy(), want, "RN features")


@pytest.mark.parametrize("case", sorted(RN_CASES))
def test_converter_and_spec_inference_are_bit_exact(case, tmp_path):
    js, ps, params, clip = rn_params(case, seed=2)
    sd = pl.clip_to_state_dict(clip)
    assert "visual.layer1.0.downsample.0.weight" in sd and "visual.proj" not in sd
    sd_np = {k: v.numpy() for k, v in sd.items()}
    want, jspec = jl.state_dict_to_params(sd_np)
    got, pspec = pl.state_dict_to_params(sd)
    assert dataclasses.asdict(pspec) == dataclasses.asdict(jspec)
    assert dataclasses.asdict(pspec.vision_rn) == dataclasses.asdict(js.vision_rn)
    same_trees(got, np_tree(want))
    same_trees(got, params)  # the round trip through the OpenAI layout
    path = tmp_path / "RN.pt"
    torch.save(sd, path)
    jparams, _ = jl.load_clip("RN50", checkpoint_path=str(path))
    pclip, spec = pl.load_clip("RN50", checkpoint_path=str(path), device="cpu")
    assert spec == pspec
    same_trees(bridge.module_to_jax(pclip), np_tree(jparams))


def test_presets_and_random_branch_match():
    assert {k: dataclasses.asdict(v) for k, v in pr.RN_SPECS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jr.RN_SPECS.items()}
    clip, spec = pl.load_clip("RN50", checkpoint_path="random", device="cpu")
    assert spec.vision_rn == pr.RN_SPECS["RN50"] and spec.embed_dim == 1024
    assert isinstance(clip.visual, pr.ModifiedResNet)
    # the random RN50 tree has the reference's leaves and shapes
    jspec = jc.CLIPSpec(embed_dim=1024, vision_rn=jr.RN_SPECS["RN50"])
    shapes = jax.eval_shape(lambda: jc.init_clip_params(jax.random.PRNGKey(0), jspec))
    want = flat(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    got = flat(bridge.module_to_jax(clip))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k


@pytest.mark.parametrize("case", sorted(RN_CASES))
def test_init_tree_matches_the_reference(case):
    js, ps = spec_pair(case)
    want = flat(np_tree(jr.init_resnet_params(jax.random.PRNGKey(0), js.vision_rn)))
    got = flat(bridge.module_to_jax(pr.init_resnet_params(torch.Generator().manual_seed(0),
                                                          ps.vision_rn)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k.endswith((".mean", ".bias")) and not k.startswith("attnpool"):
            assert not np.any(got[k]), k


@pytest.mark.parametrize("method", ["kadaptation", "adapter"])
def test_peft_hooks_on_an_rn_tower_raise(method):
    js, ps, params, clip = rn_params("64px")
    x = torch.zeros(1, 64, 64, 3)
    hooks = make_hooks(PeftConfig(method=method), ps, train=False)
    with pytest.raises(ValueError, match="ViT-only"):
        pc.encode_image(clip, x, spec=ps, hooks=hooks)
