"""The DeCLIP family against pevit_tpu/models/declip.py and the DeCLIP
tokenizer against pevit_tpu/data/tokenizer.py, fp32, at toy width:

* ``encode_image`` (both MLP routes) / ``encode_image_dense`` /
  ``encode_text`` / ``encode_text_dense`` at 1e-5, with and without the
  text positional embedding;
* the converter (text under ``encode_text.`` or SLIP's ``text_encoder.``,
  the FILIP heads, the ignored pretraining subtrees, ``module.`` prefixes
  and the ``model`` / ``state_dict`` wrappers) bit for bit;
* ``DeclipSpec.from_config`` equals the reference's for every shipped
  DeCLIP YAML, at 224 px and at a toy size;
* ``declip_tokenize``: ids exactly equal, with the silent truncation.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu.config import update_config as jax_update
from pevit_tpu.core.clip import TextSpec, VisionSpec
from pevit_tpu.data import tokenizer as jtok
from pevit_tpu.models import declip as jd
from pevit_tpu_torch import bridge
from pevit_tpu_torch.config import get_default_config, update_config
from pevit_tpu_torch.core import clip as pc
from pevit_tpu_torch.data import tokenizer as ptok
from pevit_tpu_torch.models import declip as pd

from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)
from .test_torch_vit import close, flat, np_tree, same_trees

REPO = Path(__file__).resolve().parents[1]
DECLIP_YAMLS = ["vitb32_DeCLIP", "vitb32_DeCLIP_YFCC15M", "vitb32_FILIP", "vitb32_SLIP"]


def spec_pair(variant="declip", pos_flag=True):
    js = jd.DeclipSpec(
        variant=variant, embed_dim=16,
        vision=VisionSpec(input_resolution=64, patch_size=32, width=64, layers=2, heads=2,
                          output_dim=16),
        text=TextSpec(context_length=8, vocab_size=64, width=32, heads=2, layers=2,
                      output_dim=16),
        dense_embed_dim=12, positional_embedding_flag=pos_flag)
    ps = pd.DeclipSpec(variant=variant, embed_dim=16,
                       vision=pc.VisionSpec(**dataclasses.asdict(js.vision)),
                       text=pc.TextSpec(**dataclasses.asdict(js.text)),
                       dense_embed_dim=12, positional_embedding_flag=pos_flag)
    return js, ps


def models(variant, pos_flag=True, seed=0):
    js, ps = spec_pair(variant, pos_flag)
    params = jd.init_declip_params(jax.random.PRNGKey(seed), js)
    return js, ps, params, pd.declip_from_params(np_tree(params), ps, device="cpu")


def tokens(seed=0, n=4, length=8, vocab=64):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, vocab - 1, (n, length)).astype(np.int32)
    t[np.arange(n), rng.integers(1, length, n)] = vocab - 1  # an EOT per row
    return t


@pytest.mark.parametrize("use_fused_mlp", [True, False])
@pytest.mark.parametrize("variant", ["declip", "slip", "filip"])
def test_encode_image_matches(variant, use_fused_mlp):
    js, ps, params, model = models(variant)
    x = np.random.default_rng(1).standard_normal((3, 64, 64, 3)).astype(np.float32)
    want = jd.encode_image(params, jnp.asarray(x), spec=js)
    got = pd.encode_image(model, torch.from_numpy(x), spec=ps, use_fused_mlp=use_fused_mlp)
    close(got.detach().numpy(), want, "pooled image features")


@pytest.mark.parametrize("use_fused_mlp", [True, False])
def test_encode_image_dense_matches(use_fused_mlp):
    js, ps, params, model = models("filip")
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = jd.encode_image_dense(params, jnp.asarray(x), spec=js)
    got = pd.encode_image_dense(model, torch.from_numpy(x), spec=ps, use_fused_mlp=use_fused_mlp)
    assert got.shape == (2, 4, 12)
    close(got.detach().numpy(), want, "dense image features")


@pytest.mark.parametrize("pos_flag", [True, False])
@pytest.mark.parametrize("variant", ["declip", "filip"])
def test_encode_text_matches(variant, pos_flag):
    js, ps, params, model = models(variant, pos_flag, seed=3)
    t = tokens(seed=int(pos_flag))
    want = jd.encode_text(params, jnp.asarray(t), spec=js)
    got = pd.encode_text(model, torch.from_numpy(t).long(), spec=ps)
    close(got.detach().numpy(), want, "pooled text features")
    if variant == "filip":
        want = jd.encode_text_dense(params, jnp.asarray(t), spec=js)
        got = pd.encode_text_dense(model, torch.from_numpy(t).long(), spec=ps)
        assert got.shape == (4, 8, 12)
        close(got.detach().numpy(), want, "dense text features")


@pytest.mark.parametrize("variant", ["declip", "filip"])
def test_init_tree_matches_the_reference(variant):
    js, ps = spec_pair(variant)
    want = flat(np_tree(jd.init_declip_params(jax.random.PRNGKey(0), js)))
    got = flat(bridge.module_to_jax(pd.init_declip_params(torch.Generator().manual_seed(0), ps,
                                                          device="cpu")))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
    assert not np.any(got["text.text_projection.bias"])


def declip_state_dict(rng, *, text_prefix="encode_text", dense=False, vocab=65, context=8):
    """A DeCLIP-family checkpoint's state dict from seeded tensors: the CLIP
    ViT layout under ``visual.``, the text tower under ``text_prefix``, the
    FILIP heads when ``dense``, and pretraining-only subtrees."""
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    w, tw, e, p, grid = 64, 32, 16, 32, 2
    sd = {"visual.conv1.weight": r(w, 3, p, p), "visual.class_embedding": r(w),
          "visual.positional_embedding": r(grid * grid + 1, w), "visual.proj": r(w, e),
          "logit_scale": r(1)}
    for pre, n in (("visual.ln_pre", w), ("visual.ln_post", w), (f"{text_prefix}.ln_final", tw)):
        sd[f"{pre}.weight"], sd[f"{pre}.bias"] = r(n), r(n)
    for prefix, width, layers in (("visual.transformer.resblocks", w, 2),
                                  (f"{text_prefix}.transformer.resblocks", tw, 1)):
        for i in range(layers):
            b = f"{prefix}.{i}"
            sd.update({f"{b}.attn.in_proj_weight": r(3 * width, width),
                       f"{b}.attn.in_proj_bias": r(3 * width),
                       f"{b}.attn.out_proj.weight": r(width, width),
                       f"{b}.attn.out_proj.bias": r(width),
                       f"{b}.mlp.c_fc.weight": r(4 * width, width), f"{b}.mlp.c_fc.bias": r(4 * width),
                       f"{b}.mlp.c_proj.weight": r(width, 4 * width), f"{b}.mlp.c_proj.bias": r(width),
                       f"{b}.ln_1.weight": r(width), f"{b}.ln_1.bias": r(width),
                       f"{b}.ln_2.weight": r(width), f"{b}.ln_2.bias": r(width)})
    sd.update({f"{text_prefix}.token_embedding.weight": r(vocab, tw),
               f"{text_prefix}.positional_embedding": r(context, tw),
               f"{text_prefix}.text_projection.weight": r(e, tw),
               f"{text_prefix}.text_projection.bias": r(e),
               "projector.layer1.weight": r(4, 4), "predictor.fc.weight": r(4, 4),
               "text_label_predictor.bias": r(4)})
    if dense:
        sd.update({"image_mapping.weight": r(12, w), "image_mapping.bias": r(12),
                   "text_mapping.weight": r(12, tw), "text_mapping.bias": r(12),
                   "logit_scale_dense": r(1)})
    return sd


@pytest.mark.parametrize("wrapper", ["model", "state_dict"])
@pytest.mark.parametrize("text_prefix,dense", [("encode_text", False), ("text_encoder", False),
                                               ("encode_text", True)])
def test_converter_is_bit_exact(text_prefix, dense, wrapper):
    sd = declip_state_dict(np.random.default_rng(5), text_prefix=text_prefix, dense=dense)
    raw = {wrapper: {f"module.{k}": v for k, v in sd.items()}, "epoch": 3}
    jsd, psd = jd.normalize_declip_state_dict(raw), pd.normalize_declip_state_dict(raw)
    assert jsd.keys() == psd.keys() == sd.keys()
    want, jspec = jd.declip_state_dict_to_params(jsd, input_resolution=64)
    got, pspec = pd.declip_state_dict_to_params(psd, input_resolution=64)
    assert dataclasses.asdict(pspec) == dataclasses.asdict(jspec)
    assert pspec.dense_eval is dense and pspec.text.vocab_size == 65
    same_trees(got, np_tree(want))
    same_trees(bridge.module_to_jax(pd.declip_from_params(got, pspec, device="cpu")), got)


def yaml_config(make, update, name, res=224, **over):
    cfg = make()

    class Args:
        cfg = str(REPO / "resources/model" / f"{name}.yaml")
        opts = [x for k, v in over.items() for x in (k, v)] + ["TRAIN.IMAGE_SIZE", f"[{res},{res}]"]

    update(cfg, Args)
    return cfg


@pytest.mark.parametrize("res", [224, 64])
@pytest.mark.parametrize("name", DECLIP_YAMLS)
def test_spec_from_config_matches(name, res):
    want = jd.DeclipSpec.from_config(yaml_config(jax_defaults, jax_update, name, res))
    got = pd.DeclipSpec.from_config(yaml_config(get_default_config, update_config, name, res))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.text.vocab_size == 49409
    if res == 224:
        assert (got.vision.width, got.vision.heads, got.vision.seq_len) == (768, 12, 50)


TEXTS = ["a photo of a cat.", "a bad photo of the 2 dogs!", "ÉLAN vital; naïve café",
         " ".join(["word"] * 90), "", "<|startoftext|> x <|endoftext|>"]


@pytest.mark.parametrize("length", [77, 16, 5])
def test_declip_tokenize_ids_equal(length):
    want = jtok.declip_tokenize(TEXTS, length)
    got = ptok.declip_tokenize(TEXTS, length)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    # the shifted vocabulary: sot 49407, eot 49408; the long text keeps its eot
    assert got[0, 0] == 49407 and got[3, -1] == 49408
    assert np.array_equal(ptok.declip_tokenize("a photo of a cat.", length)[0], got[0])


def test_mask_token_vocabulary_matches():
    want, got = jtok.ClipTokenizer(mask_token=True), ptok.ClipTokenizer(mask_token=True)
    assert got.encoder == want.encoder and len(got.encoder) == 49409
    assert got.encoder["<|mask|>"] == 49406
    # the plain vocabulary keeps its ids
    assert ptok.ClipTokenizer().encoder["<|endoftext|>"] == 49407
