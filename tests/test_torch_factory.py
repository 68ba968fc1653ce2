"""``models.get_model`` against pevit_tpu/models/factory.py for each shipped
model YAML, at toy size (32 px, one or two narrow layers; CLIP names with
random weights; ``clip_swin_tiny`` two stages of two 16-wide blocks,
window 4): the same ``feat_dim``; the reference's parameter tree loads into
the port's backbone through the bridge, leaf for leaf; the forward features
(and the text features, where the backbone has a text tower) then agree at
1e-5 in fp32.  A checkpoint through TEST.MODEL_FILE (timm and DeCLIP
layouts) gives the same tree bit for bit.  The Swin names build from
MODEL.NAME alone and match.
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
from pevit_tpu.models import get_model as jax_get_model
from pevit_tpu_torch import bridge
from pevit_tpu_torch.config import get_default_config, update_config
from pevit_tpu_torch.models import get_model

from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)
from .test_torch_declip import declip_state_dict
from .test_torch_vit import close, np_tree, same_trees, timm_state_dict

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(p.stem for p in (REPO / "resources/model").glob("*.yaml"))
TOY_SWIN = {"EMBED_DIM": 16, "DEPTHS": [2, 2], "NUM_HEADS": [2, 2], "WINDOW_SIZE": 4}


def listless(tree):
    """Swin's lists of stages and blocks as index-keyed dicts (what ``flat``
    walks)."""
    if isinstance(tree, list):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: listless(v) for k, v in tree.items()}
    return tree


def toy_config(make, update, name, *opts, res=32):
    """The shipped YAML at toy size."""
    cfg = make()

    class Args:
        cfg = str(REPO / "resources/model" / f"{name}.yaml")
        opts_ = ["TRAIN.IMAGE_SIZE", f"[{res},{res}]", "DATASET.NUM_CLASSES", "3", *opts]

    Args.opts = Args.opts_
    update(cfg, Args)
    cfg.defrost()
    spec = cfg.MODEL.SPEC
    mname = cfg.MODEL.NAME
    if mname.startswith("clip_swin"):
        spec.EMBED_DIM = 16
        if "VISION" not in spec:
            spec.VISION = type(spec)()
        spec.VISION.update(TOY_SWIN)
        spec.TEXT.WIDTH, spec.TEXT.LAYERS, spec.TEXT.HEADS = 32, 1, 2
    elif mname.startswith(("cls_swin", "swin")):
        spec.update(TOY_SWIN)
    elif mname.startswith(("ViT-", "RN")) or "TEXT" in spec and "VISION" in spec:
        cfg.MODEL.PRETRAINED = "random"
        spec.EMBED_DIM = 16
        spec.VISION.WIDTH, spec.VISION.LAYERS = 64, 2
        spec.TEXT.WIDTH, spec.TEXT.LAYERS, spec.TEXT.HEADS = 32, 1, 2
    elif mname.startswith(("vit_", "deit_", "mae_", "mocov3_")):
        spec.EMBED_DIM, spec.DEPTH, spec.NUM_HEADS = 64, 2, 2
    cfg.freeze()
    return cfg


def pair(name, *opts, res=32):
    return (toy_config(jax_defaults, jax_update, name, *opts, res=res),
            toy_config(get_default_config, update_config, name, *opts, res=res))


def images(n, res, seed=0):
    return np.random.default_rng(seed).standard_normal((n, res, res, 3)).astype(np.float32)


@pytest.mark.parametrize("name", YAMLS)
def test_every_shipped_yaml_builds_and_matches(name):
    res = 28 if name == "vitl14_CLIP" else 32
    jcfg, pcfg = pair(name, res=res)
    jb = jax_get_model(jcfg)
    pb = get_model(pcfg, device="cpu")
    assert pb.feat_dim == jb.feat_dim and pb.name == jb.name
    assert (pb.encode_text is None) == (jb.encode_text is None)
    assert (pb.tokenize is None) == (jb.tokenize is None)
    bridge.module_from_jax(np_tree(jb.params), pb.params, device="cpu")
    same_trees(listless(bridge.module_to_jax(pb.params)), listless(np_tree(jb.params)))
    x = images(3, res)
    want = jb.forward_features(jb.params, jnp.asarray(x))
    for fused in (True, False):
        got = pb.forward_features(pb.params, torch.from_numpy(x), use_fused_mlp=fused)
        assert got.shape == (3, pb.feat_dim)
        close(got.detach().numpy(), want, f"{name} features")
    if jb.encode_text is not None:
        length = pcfg.MODEL.SPEC.TEXT.CONTEXT_LENGTH
        texts = ["a photo of a dog.", "a cat"]
        if jb.tokenize is not None:
            toks = jb.tokenize(texts, length)
            assert np.array_equal(pb.tokenize(texts, length), toks)
        else:
            from pevit_tpu.data.tokenizer import tokenize

            toks = tokenize(texts, length, truncate=True)
        want = jb.encode_text(jb.params, jnp.asarray(toks))
        got = pb.encode_text(pb.params, torch.from_numpy(np.asarray(toks)).long())
        close(got.detach().numpy(), want, f"{name} text features")


@pytest.mark.parametrize("name", ["cls_swin_tiny", "swin_base", "clip_swin"])
def test_swin_names_build_and_match_jax(name):
    """The Swin names from MODEL.NAME over another YAML, at toy size, random
    weights bridged from JAX's: the same tree and features."""
    jcfg, pcfg = pair("vit_base_patch16_224", "MODEL.NAME", name)
    jb, pb = jax_get_model(jcfg), get_model(pcfg, device="cpu")
    assert pb.feat_dim == jb.feat_dim == (16 if name == "clip_swin" else 32)
    assert (pb.encode_text is None) == (jb.encode_text is None) == (name != "clip_swin")
    bridge.module_from_jax(np_tree(jb.params), pb.params, device="cpu")
    same_trees(listless(bridge.module_to_jax(pb.params)), listless(np_tree(jb.params)))
    x = images(2, 32, seed=3)
    close(pb.forward_features(pb.params, torch.from_numpy(x)).detach().numpy(),
          jb.forward_features(jb.params, jnp.asarray(x)), f"{name} features")


def test_an_unknown_name_raises():
    _, pcfg = pair("vit_base_patch16_224", "MODEL.NAME", "resnet_foo")
    with pytest.raises(ValueError, match="Unknown MODEL.NAME"):
        get_model(pcfg, device="cpu")


@pytest.mark.parametrize("name,layout", [("vit_base_patch16_224", "timm"),
                                         ("mae_vitb16", "mae"), ("mocov3_vitb16", "mocov3")])
def test_a_timm_checkpoint_loads_bit_for_bit(name, layout, tmp_path):
    from .test_torch_vit import wrap

    sd = timm_state_dict(np.random.default_rng(7), patch=16, grid=2, fc_norm=layout == "mae")
    path = tmp_path / "vit.pth"
    torch.save({k: torch.from_numpy(v) for k, v in wrap(sd, "timm").items()}
               if layout == "timm" else
               jax.tree.map(lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
                            wrap(sd, layout)), path)
    jcfg, pcfg = pair(name, "TEST.MODEL_FILE", str(path))
    jb, pb = jax_get_model(jcfg), get_model(pcfg, device="cpu")
    same_trees(bridge.module_to_jax(pb.params), np_tree(jb.params))
    assert pb.feat_dim == jb.feat_dim == 64
    x = images(2, 32, seed=1)
    close(pb.forward_features(pb.params, torch.from_numpy(x)).detach().numpy(),
          jb.forward_features(jb.params, jnp.asarray(x)), f"{name} features")


@pytest.mark.parametrize("name,dense", [("vitb32_DeCLIP", False), ("vitb32_FILIP", True)])
def test_a_declip_checkpoint_loads_bit_for_bit(name, dense, tmp_path):
    sd = declip_state_dict(np.random.default_rng(8), dense=dense)
    path = tmp_path / "declip.pth.tar"
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    jcfg, pcfg = pair(name, "TEST.MODEL_FILE", str(path), res=64)
    jb, pb = jax_get_model(jcfg), get_model(pcfg, device="cpu")
    same_trees(bridge.module_to_jax(pb.params), np_tree(jb.params))
    assert pb.feat_dim == jb.feat_dim == (4 * 12 if dense else 16)
    x = images(2, 64, seed=2)
    close(pb.forward_features(pb.params, torch.from_numpy(x)).detach().numpy(),
          jb.forward_features(jb.params, jnp.asarray(x)), f"{name} features")
