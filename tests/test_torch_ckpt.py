"""The port's checkpoint loader against pevit_tpu/ckpt/torch_loader.py, on
OpenAI-layout state dicts that the test writes (the tiny CLIP of
tests/test_ckpt_parity.py: vision 128 x 2 layers, patch 16, 32 px; text
64 x 2 layers):

* ``state_dict_to_params`` and ``infer_spec_from_state_dict`` equal the
  reference's exactly, and ``load_clip`` puts every tensor into the port's
  ``CLIP`` bit for bit as the reference's converter plus ``bridge`` does;
* the port's ``encode_image`` / ``encode_text`` on the loaded tower agree
  with the reference's on its converted tree within 1e-5 of the largest
  feature (float32, matmul precision highest);
* a ``torch.save`` pickle, its ``{"state_dict": ...}`` and ``{"model":
  ...}`` wrappers and a TorchScript archive all load the same weights;
* ``clip_to_state_dict`` inverts the loader;
* a ResNet checkpoint raises; ``load_clip`` resolves an explicit path, then
  the cache dir, then random weights, as the reference does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pevit_tpu.ckpt import torch_loader as jloader
from pevit_tpu.core import encode_image as jencode_image
from pevit_tpu.core import encode_text as jencode_text
from pevit_tpu_torch import bridge
from pevit_tpu_torch.ckpt import (
    clip_to_state_dict,
    infer_spec_from_state_dict,
    load_clip,
    read_torch_state_dict,
    state_dict_to_params,
)
from pevit_tpu_torch.core import encode_image, encode_text

from .test_ckpt_parity import CTX, RES, VOCAB, TorchCLIP, openai_style_state_dict

TOL = 1e-5


@pytest.fixture(scope="module")
def openai_sd():
    torch.manual_seed(0)
    return openai_style_state_dict(TorchCLIP().eval())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _as_port_spec(spec):
    from pevit_tpu_torch.core.clip import CLIPSpec, TextSpec, VisionSpec

    return CLIPSpec(embed_dim=spec.embed_dim,
                    vision=VisionSpec(**{f: getattr(spec.vision, f) for f in
                                         VisionSpec.__dataclass_fields__}),
                    text=TextSpec(**{f: getattr(spec.text, f) for f in TextSpec.__dataclass_fields__}))


def test_conversion_equals_the_reference(openai_sd):
    want, jspec = jloader.state_dict_to_params(openai_sd)
    got, spec = state_dict_to_params(openai_sd)
    assert spec == _as_port_spec(jspec)
    assert spec.vision.width == 128 and spec.vision.patch_size == 16 and spec.text.layers == 2
    want, got = _flat(jax.tree.map(np.asarray, want)), _flat(got)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _write(path, obj):
    torch.save(obj, path)
    return str(path)


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


class Holder(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _scripted(sd):
    """A TorchScript module whose state dict carries ``sd``'s OpenAI names."""
    root = Holder()
    for key, value in sd.items():
        *path, leaf = key.split(".")
        module = root
        for name in path:
            if name not in module._modules:
                module.add_module(name, Holder())
            module = module._modules[name]
        module.register_parameter(leaf, nn.Parameter(value.clone()))
    return torch.jit.script(root)


@pytest.mark.parametrize("layout", ["pickle", "state_dict", "model", "torchscript"])
def test_load_clip_is_bit_exact_against_the_reference(openai_sd, tmp_path, layout):
    sd = _tensors(openai_sd)
    path = tmp_path / "ViT-B-32.pt"
    if layout == "torchscript":
        torch.jit.save(_scripted(sd), str(path))
    else:
        _write(path, sd if layout == "pickle" else {layout: sd, "epoch": 3})
    read = read_torch_state_dict(str(path))
    assert read.keys() == openai_sd.keys()
    want_params, jspec = jloader.load_clip("ViT-B/32", checkpoint_path=str(path))
    clip, spec = load_clip("ViT-B/32", checkpoint_path=str(path), device="cpu")
    assert spec == _as_port_spec(jspec)
    want = bridge.clip_from_jax(jax.tree.map(np.asarray, want_params), spec, device="cpu")
    got_sd, want_sd = clip.state_dict(), want.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for name, t in want_sd.items():
        assert got_sd[name].dtype == torch.float32 and torch.equal(got_sd[name], t), name


def test_encoders_on_the_loaded_tower_match_the_reference(openai_sd, tmp_path):
    path = _write(tmp_path / "clip.pt", _tensors(openai_sd))
    params, jspec = jloader.load_clip("ViT-B/32", checkpoint_path=path)
    clip, spec = load_clip("ViT-B/32", checkpoint_path=path, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, RES, RES, 3)).astype(np.float32)
    toks = rng.integers(1, VOCAB - 1, (4, CTX))
    toks[np.arange(4), rng.integers(3, CTX, 4)] = VOCAB - 1  # EOT = the highest id
    with jax.default_matmul_precision("highest"):
        want_img = np.asarray(jencode_image(params, jnp.asarray(x), spec=jspec))
        want_txt = np.asarray(jencode_text(params, jnp.asarray(toks.astype(np.int32)), spec=jspec))
    with torch.no_grad():
        got_img = encode_image(clip, torch.from_numpy(x), spec=spec).numpy()
        got_txt = encode_text(clip, torch.from_numpy(toks), spec=spec).numpy()
    for got, want, what in ((got_img, want_img, "image"), (got_txt, want_txt, "text")):
        assert got.shape == want.shape
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= TOL * scale, f"{what} features: max err {err} > {TOL} * {scale}"


def test_clip_to_state_dict_inverts_the_loader(openai_sd, tmp_path):
    clip, spec = load_clip("ViT-B/32", checkpoint_path=_write(tmp_path / "c.pt", _tensors(openai_sd)),
                           device="cpu")
    back = clip_to_state_dict(clip)
    assert back.keys() == openai_sd.keys()
    for name, t in back.items():
        np.testing.assert_array_equal(t.numpy(), openai_sd[name], err_msg=name)
    assert infer_spec_from_state_dict(back) == spec


def test_a_resnet_checkpoint_raises(openai_sd):
    rn = {k: v for k, v in openai_sd.items() if not k.startswith("visual.")}
    rn["visual.layer1.0.conv1.weight"] = np.zeros((64, 64, 1, 1), np.float32)
    with pytest.raises(NotImplementedError, match="auxiliary backbones"):
        state_dict_to_params(rn)
    with pytest.raises(NotImplementedError, match="auxiliary backbones"):
        load_clip("RN50", checkpoint_path="random", device="cpu")


def test_resolution_order_is_the_reference_s(openai_sd, tmp_path):
    cache = tmp_path / "cache"
    cache.mkdir()
    path = _write(cache / "ViT-B-32.pt", _tensors(openai_sd))
    # the cache dir, by the model's canonical file name
    clip, spec = load_clip("ViT-B/32", cache_dir=str(cache), device="cpu")
    assert spec.vision.width == 128
    np.testing.assert_array_equal(clip.visual.proj.detach().numpy(), openai_sd["visual.proj"])
    # an explicit path wins over the cache dir
    other = dict(_tensors(openai_sd), **{"visual.proj": torch.zeros(128, 32)})
    explicit = _write(tmp_path / "other.pt", other)
    clip, _ = load_clip("ViT-B/32", checkpoint_path=explicit, cache_dir=str(cache), device="cpu")
    assert not clip.visual.proj.any()
    # "random" skips the checkpoint; a missing file falls back to random
    # weights, or raises without allow_random, as the reference does
    hint = spec.__class__(embed_dim=16, vision=spec.vision.__class__(
        input_resolution=32, patch_size=16, width=64, layers=1, heads=1, output_dim=16),
        text=spec.text.__class__(context_length=8, vocab_size=32, width=64, heads=1, layers=1,
                                 output_dim=16))
    for ckpt in ("random", str(tmp_path / "missing.pt")):
        clip, got = load_clip("ViT-B/32", checkpoint_path=ckpt, cache_dir=str(cache),
                              spec_hint=hint, device="cpu")
        assert got == hint and clip.visual.proj.shape == (64, 16)
    for fn in (jloader.load_clip, lambda *a, **k: load_clip(*a, device="cpu", **k)):
        with pytest.raises(FileNotFoundError):
            fn("ViT-B/32", checkpoint_path=str(tmp_path / "missing.pt"), allow_random=False)
    assert path == str(cache / "ViT-B-32.pt")
