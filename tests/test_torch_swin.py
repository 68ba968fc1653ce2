"""The Swin classifier and CLIP-Swin (``models/swin.py``, the factory's
Swin names) against pevit_tpu.models.swin, fp32, at toy geometry:

* ``swin_forward_features`` and ``swin_forward``, forward and the
  gradients of every parameter and of the input, at 1e-5 of the largest
  magnitude: a shifted stage (res 14 > window 7) beside a clamped-shift one
  (res 7 == window), a clamped window (res 6 < window 12, a smaller bias
  table), APE with seeded layer-scale gammas, and no qkv bias or patch norm
  with a QK_SCALE; real Swin-tiny geometry at 224 px is ``slow``;
* both converters bit for bit on seeded state dicts, with gamma, APE and
  qkv-bias / patch-norm detection, and the bridge's round trip;
* drop path: rate 0 in train mode equals eval, drops are per sample, the
  per-block rate rises linearly from 0, the estimator is unbiased within a
  stated bound, and train mode with a rate and no generator raises;
* ``get_model`` on ``cls_swin_tiny``, ``swin_base`` and ``clip_swin`` (random
  weights bridged from JAX's, and from a checkpoint through TEST.MODEL_FILE):
  features, and CLIP-Swin's text features;
* the ``linear_probe`` command on a toy ``clip_swin_tiny`` checkpoint
  against the reference's, and ``finetune`` with DROP_PATH_RATE on the
  port (its train-mode forward).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.commands import linear_probe as jlinear_probe
from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu.models import get_model as jax_get_model
from pevit_tpu.models import swin as js
from pevit_tpu_torch import bridge
from pevit_tpu_torch.commands import finetune as pfinetune
from pevit_tpu_torch.commands import linear_probe as plinear_probe
from pevit_tpu_torch.config import get_default_config
from pevit_tpu_torch.models import get_model
from pevit_tpu_torch.models import swin as ps

from .test_swin_ckpt import synthetic_official_sd
from .test_torch_backbone_commands import fixed_heads  # noqa: F401  (fixture)
from .test_torch_vit import close, flat, np_tree

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5


def listless(tree):
    """A tree with its lists as index-keyed dicts (what ``flat`` walks)."""
    if isinstance(tree, list):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: listless(v) for k, v in tree.items()}
    return tree


def same(got, want):
    got, want = flat(listless(got)), flat(listless(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def pspec(spec: js.SwinSpec) -> ps.SwinSpec:
    return ps.SwinSpec(**dataclasses.asdict(spec))


def seeded_params(spec, seed=0, gamma_noise=False):
    params = js.init_swin_params(jax.random.PRNGKey(seed), spec)
    if gamma_noise:  # layer scale away from its 1e-4 init, so it counts
        rng = np.random.default_rng(seed)
        for st in params["stages"]:
            for bp in st["blocks"]:
                bp["gamma"] = jnp.asarray(rng.uniform(0.5, 1.5, bp["gamma"].shape), jnp.float32)
    return params


def images(n, res, seed=1):
    return np.random.default_rng(seed).standard_normal((n, res, res, 3)).astype(np.float32)


GEOMETRIES = {
    "shifted-and-clamped-shift": dict(img_size=56, window_size=7),
    "clamped-window": dict(img_size=48, window_size=12),
    "ape-layer-scale": dict(img_size=56, window_size=7, ape=True, layer_scale=True),
    "no-qkv-bias-no-patch-norm-qk-scale": dict(img_size=56, window_size=7, qkv_bias=False,
                                               patch_norm=False, qk_scale=0.3),
}


def _grads_match(spec, params, x, *, head):
    """Forward and gradients of a seeded linear loss, both stacks."""
    pspec_ = pspec(spec)
    model = ps.swin_from_params(np_tree(params), pspec_, device="cpu")
    fwd_j = js.swin_forward if head else js.swin_forward_features
    fwd_p = ps.swin_forward if head else ps.swin_forward_features
    want = np.asarray(fwd_j(params, jnp.asarray(x), spec=spec))
    w = np.random.default_rng(2).standard_normal(want.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want_g, want_dx = jax.jit(jax.grad(
            lambda p, xx: jnp.sum(fwd_j(p, xx, spec=spec) * w), argnums=(0, 1)))(
                params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = fwd_p(model, xt, spec=pspec_)
    close(got.detach().numpy(), want, "features")
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                [xt] + [p for _, p in model.named_parameters()])
    close(grads[0].numpy(), np.asarray(want_dx), "d input")
    got_g = flat(listless(bridge.module_to_jax(_grad_module(model, names, grads[1:]))))
    want_g = flat(listless(np_tree(want_g)))
    assert got_g.keys() == want_g.keys()
    for k in want_g:
        assert np.any(want_g[k]), k
        close(got_g[k], want_g[k], f"grad {k}")


def _grad_module(model, names, grads):
    """A copy of ``model`` holding the gradients in its parameters."""
    import copy

    g = copy.deepcopy(model)
    with torch.no_grad():
        for (n, p), d in zip(g.named_parameters(), grads):
            p.copy_(d)
    return g


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_forward_and_gradients_match_jax(geometry):
    spec = js.SwinSpec(patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                       num_classes=5, **GEOMETRIES[geometry])
    params = seeded_params(spec, gamma_noise=spec.layer_scale)
    x = images(2, spec.img_size)
    _grads_match(spec, params, x, head=True)
    if geometry == "shifted-and-clamped-shift":
        p = pspec(spec)
        assert [p.block_shift(s, b) for s in range(2) for b in range(2)] == [0, 3, 0, 0]
    if geometry == "clamped-window":
        assert np.asarray(params["stages"][1]["blocks"][0]["rel_bias"]).shape[0] == 11 ** 2


def test_features_without_head_match_jax():
    spec = js.SwinSpec(img_size=56, patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                       window_size=7)
    _grads_match(spec, seeded_params(spec, seed=3), images(3, 56, seed=4), head=False)


@pytest.mark.slow
def test_real_swin_tiny_geometry_matches_jax():
    spec = js.swin_tiny()
    params = seeded_params(spec, seed=11)
    x = images(1, 224, seed=13)
    model = ps.swin_from_params(np_tree(params), pspec(spec), device="cpu")
    want = np.asarray(js.swin_forward_features(params, jnp.asarray(x), spec=spec))
    close(ps.swin_forward_features(model, torch.from_numpy(x), spec=pspec(spec)).detach().numpy(),
          want, "swin-tiny features")


# -- converters ---------------------------------------------------------------

def _sd_variant(variant):
    sd = synthetic_official_sd()
    rng = np.random.default_rng(5)
    if variant in ("gamma", "all"):
        for k in list(sd):
            if k.endswith("norm1.weight"):
                sd[k[:-len("norm1.weight")] + "gamma"] = rng.uniform(
                    0, 1, sd[k].shape).astype(np.float32)
    if variant in ("ape", "all"):
        sd["absolute_pos_embed"] = rng.standard_normal((1, 56 * 56, 32)).astype(np.float32)
    if variant in ("no-qkv-bias-no-patch-norm", "all"):
        for k in [k for k in sd if k.endswith("attn.qkv.bias")]:
            del sd[k]
        del sd["patch_embed.norm.weight"], sd["patch_embed.norm.bias"]
    return sd


@pytest.mark.parametrize("variant", ["plain", "gamma", "ape", "no-qkv-bias-no-patch-norm", "all"])
def test_swin_converter_is_bit_exact(variant):
    sd = _sd_variant(variant)
    want, wspec = js.swin_state_dict_to_params(sd)
    got, gspec = ps.swin_state_dict_to_params(sd)
    assert dataclasses.asdict(gspec) == dataclasses.asdict(wspec)
    same(got, np_tree(want))
    assert gspec.layer_scale is (variant in ("gamma", "all"))
    assert gspec.ape is (variant in ("ape", "all"))
    assert gspec.qkv_bias is (variant not in ("no-qkv-bias-no-patch-norm", "all"))
    # the module round trip keeps every leaf
    model = ps.swin_from_params(got, gspec, device="cpu")
    same(bridge.module_to_jax(model), got)


def clip_swin_state_dict(seed=0, *, vocab=500, ctx=12, width=32, layers=2, embed=24, window=7):
    """A seeded CLIP-Swin state dict in the reference's layout."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    sd = {f"visual.{k}": v for k, v in synthetic_official_sd(window=window, n_classes=5).items()
          if not k.startswith("head.")}
    sd.update({"text.token_embedding.weight": r(vocab, width),
               "text.positional_embedding": r(ctx, width),
               "text.ln_final.weight": 1 + r(width), "text.ln_final.bias": r(width),
               "text_projection": r(width, embed), "vision_projection": r(64, embed),
               "logit_scale": np.asarray(4.6, np.float32)})
    for i in range(layers):
        pre = f"text.resblocks.{i}"
        sd.update({f"{pre}.attn.in_proj_weight": r(3 * width, width),
                   f"{pre}.attn.in_proj_bias": r(3 * width),
                   f"{pre}.attn.out_proj.weight": r(width, width),
                   f"{pre}.attn.out_proj.bias": r(width),
                   f"{pre}.mlp.c_fc.weight": r(4 * width, width), f"{pre}.mlp.c_fc.bias": r(4 * width),
                   f"{pre}.mlp.c_proj.weight": r(width, 4 * width),
                   f"{pre}.mlp.c_proj.bias": r(width),
                   f"{pre}.ln_1.weight": 1 + r(width), f"{pre}.ln_1.bias": r(width),
                   f"{pre}.ln_2.weight": 1 + r(width), f"{pre}.ln_2.bias": r(width)})
    sd["text.unused_key"] = r(3)  # strict=False: ignored
    return sd


def test_clip_swin_converter_is_bit_exact():
    sd = clip_swin_state_dict()
    want, wsspec, wcspec = js.clip_swin_state_dict_to_params(sd)
    got, gsspec, gcspec = ps.clip_swin_state_dict_to_params(sd)
    assert dataclasses.asdict(gsspec) == dataclasses.asdict(wsspec)
    assert dataclasses.asdict(gcspec.text) == dataclasses.asdict(wcspec.text)
    assert gcspec.embed_dim == wcspec.embed_dim == 24
    same(got, np_tree(want))
    model = ps.clip_swin_from_params(got, gsspec, gcspec, device="cpu")
    same(bridge.module_to_jax(model), got)


# -- drop path ----------------------------------------------------------------

TINY = ps.SwinSpec(img_size=56, patch_size=4, embed_dim=16, depths=(1, 1), num_heads=(2, 2),
                   window_size=7)


def _model(spec, seed=0):
    return ps.init_swin_params(torch.Generator().manual_seed(seed), spec, device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_rate_zero_in_train_mode_equals_eval():
    m = _model(TINY)
    x = torch.from_numpy(images(4, 56))
    ev = ps.swin_forward_features(m, x, spec=TINY)
    tr = ps.swin_forward_features(m, x, spec=TINY, train=True, generator=_gen(1))
    assert torch.equal(ev, tr)


def test_train_mode_drops_paths_per_sample_and_reproducibly():
    spec = dataclasses.replace(TINY, drop_path_rate=0.8)
    m = _model(spec)
    x = torch.from_numpy(np.repeat(images(1, 56), 8, axis=0))
    ev = ps.swin_forward_features(m, x, spec=spec)
    assert torch.allclose(ev, ev[:1].expand_as(ev), atol=1e-6)
    tr = ps.swin_forward_features(m, x, spec=spec, train=True, generator=_gen(3))
    assert not torch.allclose(tr, tr[:1].expand_as(tr), atol=1e-6)  # per sample
    assert not torch.allclose(tr, ev, atol=1e-6)
    assert torch.equal(tr, ps.swin_forward_features(m, x, spec=spec, train=True,
                                                    generator=_gen(3)))
    assert not torch.equal(tr, ps.swin_forward_features(m, x, spec=spec, train=True,
                                                        generator=_gen(4)))


def test_the_per_block_rate_rises_linearly_from_zero(monkeypatch):
    spec = dataclasses.replace(TINY, depths=(2, 3), num_heads=(2, 2), drop_path_rate=0.4)
    rates = []
    real = ps._drop_path

    def spy(h, p, generator):
        rates.append(p)
        return real(h, p, generator)

    monkeypatch.setattr(ps, "_drop_path", spy)
    out = ps.swin_forward_features(_model(spec), torch.from_numpy(images(8, 56)), spec=spec,
                                   train=True, generator=_gen(0))
    assert torch.isfinite(out).all()
    # block 0 has rate 0 (never called); blocks 1-4 call it twice each
    want = np.linspace(0.0, 0.4, 5)[1:]
    np.testing.assert_allclose(rates, np.repeat(want, 2), rtol=0, atol=1e-12)


def test_drop_path_is_unbiased_and_per_sample():
    h = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 3)).astype(np.float32))
    p, n = 0.3, 200
    gen = _gen(0)
    mean = sum(ps._drop_path(h, p, gen) for _ in range(n)) / n
    # each entry averages n draws of h * Bernoulli(0.7) / 0.7: its standard
    # deviation is |h| * sqrt(0.3 / 0.7 / 200) <= 0.05 |h|, and 0.25 is five
    # of those for |h| <= 1 and the reference's bound
    np.testing.assert_allclose(mean.numpy(), h.numpy(), atol=0.25 * max(1.0, float(h.abs().max())))
    one = ps._drop_path(h, p, _gen(42))
    zero = (one == 0).all(dim=1)
    scaled = torch.isclose(one, h / (1 - p), atol=1e-6).all(dim=1)
    assert (zero | scaled).all() and zero.any() and scaled.any()
    assert abs(float(zero.float().mean()) - p) < 4 * (p * (1 - p) / 512) ** 0.5


@pytest.mark.parametrize("rate", ["DROP_PATH_RATE", "DROP_RATE"])
def test_train_mode_without_a_generator_raises(rate):
    spec = dataclasses.replace(TINY, **{"drop_path_rate" if rate == "DROP_PATH_RATE"
                                        else "drop_rate": 0.1})
    with pytest.raises(ValueError, match=rate):
        ps.swin_forward_features(_model(spec), torch.from_numpy(images(2, 56)), spec=spec,
                                 train=True)


# -- the factory --------------------------------------------------------------

def _pair(name, **spec):
    cfgs = []
    for make in (jax_defaults, get_default_config):
        cfg = make()
        cfg.defrost()
        cfg.MODEL.NAME = name
        cfg.TRAIN.IMAGE_SIZE = [32, 32]
        for k, v in spec.items():
            cfg.MODEL.SPEC[k] = v
        cfg.freeze()
        cfgs.append(cfg)
    return cfgs


TOY_SWIN = dict(EMBED_DIM=16, DEPTHS=[2, 2], NUM_HEADS=[2, 2], WINDOW_SIZE=4)
TOY_TEXT = dict(TOKENIZER="clip", CONTEXT_LENGTH=77, WIDTH=32, HEADS=2, LAYERS=1)


def _features_match(jb, pb, res=32):
    x = images(3, res, seed=6)
    want = np.asarray(jb.forward_features(jb.params, jnp.asarray(x)))
    close(pb.forward_features(pb.params, torch.from_numpy(x)).detach().numpy(), want,
          f"{pb.name} features")


@pytest.mark.parametrize("name", ["cls_swin_tiny", "swin_base"])
def test_swin_names_match_jax(name):
    jcfg, pcfg = _pair(name, **TOY_SWIN)
    jb, pb = jax_get_model(jcfg), get_model(pcfg, device="cpu")
    assert pb.feat_dim == jb.feat_dim == 32
    assert pb.forward_features_train is None and jb.forward_features_train is None
    bridge.module_from_jax(np_tree(jb.params), pb.params, device="cpu")
    same(bridge.module_to_jax(pb.params), np_tree(jb.params))
    _features_match(jb, pb)


def test_clip_swin_matches_jax_with_text_features():
    from pevit_tpu.data.tokenizer import tokenize

    jcfg, pcfg = _pair("clip_swin", EMBED_DIM=16, TEXT=TOY_TEXT, VISION=TOY_SWIN)
    jb, pb = jax_get_model(jcfg), get_model(pcfg, device="cpu")
    assert pb.feat_dim == jb.feat_dim == 16 and pb.tokenize is None
    bridge.module_from_jax(np_tree(jb.params), pb.params, device="cpu")
    same(bridge.module_to_jax(pb.params), np_tree(jb.params))
    _features_match(jb, pb)
    toks = tokenize(["a photo of a dog.", "a cat"], 77, truncate=True)
    want = np.asarray(jb.encode_text(jb.params, jnp.asarray(toks)))
    got = pb.encode_text(pb.params, torch.from_numpy(np.asarray(toks)).long())
    close(got.detach().numpy(), want, "clip_swin text features")
    np.testing.assert_allclose(np.linalg.norm(want, axis=-1), 1.0, atol=1e-6)


def test_checkpoints_load_bit_for_bit(tmp_path):
    sd = synthetic_official_sd(embed=16, depths=(2, 2), heads=(2, 2), window=4)
    path = tmp_path / "swin.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    jcfg, pcfg = _pair("cls_swin_tiny")
    for cfg in (jcfg, pcfg):
        cfg.defrost()
        cfg.TEST.MODEL_FILE = str(path)
        cfg.freeze()
    jb, pb = jax_get_model(jcfg), get_model(pcfg, device="cpu")
    same(bridge.module_to_jax(pb.params), np_tree(jb.params))
    _features_match(jb, pb)

    cpath = tmp_path / "clip_swin.pt"
    csd = clip_swin_state_dict(seed=2, vocab=49408, ctx=77)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in csd.items()}, cpath)
    jcfg, pcfg = _pair("clip_swin", TEXT=dict(TOY_TEXT, HEADS=4))
    for cfg in (jcfg, pcfg):
        cfg.defrost()
        cfg.TEST.MODEL_FILE = str(cpath)
        cfg.TRAIN.IMAGE_SIZE = [56, 56]
        cfg.freeze()
    jb, pb = jax_get_model(jcfg), get_model(pcfg, device="cpu")
    same(bridge.module_to_jax(pb.params), np_tree(jb.params))
    _features_match(jb, pb, res=56)


def test_drop_path_rate_is_consumed_and_bad_options_raise():
    jcfg, pcfg = _pair("cls_swin_tiny", DROP_PATH_RATE=0.5, **TOY_SWIN)
    pb = get_model(pcfg, device="cpu")
    assert pb.forward_features_train is not None
    x = torch.from_numpy(images(4, 32))
    tr = pb.forward_features_train(pb.params, x, _gen(0))
    ev = pb.forward_features(pb.params, x)
    assert tr.shape == ev.shape and not torch.allclose(tr, ev, atol=1e-6)
    _, pcfg = _pair("clip_swin", TEXT=dict(TOY_TEXT, TOKENIZER="bert"))
    with pytest.raises(ValueError, match="TOKENIZER"):
        get_model(pcfg, device="cpu")
    _, pcfg = _pair("cls_swin_tiny", IN_CHANS=4)
    with pytest.raises(ValueError, match="IN_CHANS"):
        get_model(pcfg, device="cpu")


# -- the commands ---------------------------------------------------------------

def toy_clip_swin_yaml(tmp_path) -> str:
    """clip_swin_tiny.yaml at toy width: text 32 wide, one layer; Swin 16
    wide, two stages of two blocks, window 4 (at 32 px: a shifted stage and
    a one-window stage)."""
    text = (REPO / "resources/model/clip_swin_tiny.yaml").read_text()
    for a, b in (("EMBED_DIM: 512", "EMBED_DIM: 24"), ("WIDTH: 512", "WIDTH: 32"),
                 ("HEADS: 8", "HEADS: 2"), ("LAYERS: 12", "LAYERS: 1"),
                 ("EMBED_DIM: 96", "EMBED_DIM: 32"), ("DEPTHS: [2, 2, 6, 2]", "DEPTHS: [2, 2]"),
                 ("NUM_HEADS: [3, 6, 12, 24]", "NUM_HEADS: [2, 4]"),
                 ("WINDOW_SIZE: 7", "WINDOW_SIZE: 4")):
        assert a in text
        text = text.replace(a, b)
    path = tmp_path / "toy_clip_swin.yaml"
    path.write_text(text)
    return str(path)


def _command_argv(out, yaml, ckpt, *options, device=(), text_head=True):
    return ["--ds", str(REPO / "resources/datasets/cifar10.yaml"), "--model", yaml, *options,
            *device, "DATASET.NUM_SAMPLES_PER_CLASS", "5", "DATASET.RANDOM_SEED_SAMPLING", "0",
            "TRAIN.INIT_HEAD_WITH_TEXT_ENCODER", str(text_head), "TEST.MODEL_FILE", ckpt,
            "DATASET.ALLOW_SYNTHETIC", "True", "DATASET.ROOT", str(out / "data"),
            "OUTPUT_DIR", str(out / "out"), "TRAIN.IMAGE_SIZE", "[32,32]",
            "TPU.PARITY_FP32", "True", "TRAIN.END_EPOCH", "1", "TRAIN.EXTRA_FINAL_TRAIN_EPOCH",
            "1"]


def _predictions(out, folder):
    base = out / "out" / "predictions" / folder / "seed0_cifar-10"
    return json.loads(base.with_suffix(".json").read_text()), base.with_suffix(".txt").read_text()


@pytest.fixture(scope="module")
def clip_swin_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip_swin") / "clip_swin.pt"
    sd = clip_swin_state_dict(seed=3, vocab=49408, ctx=77, layers=1, window=4)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    return str(path)


def test_linear_probe_on_clip_swin_matches_the_reference(monkeypatch, fixed_heads, tmp_path,
                                                         clip_swin_ckpt):
    """Without the text head: the reference's text head for an auxiliary
    backbone raises and falls back to a random one (ROADMAP §3), so both
    packages take ``fixed_heads``' seeded kernel."""
    monkeypatch.chdir(REPO)
    yaml = toy_clip_swin_yaml(tmp_path)
    options = ("--no-tuning", "True", "--lr", "0.01", "--l2", "0.001")
    with jax.default_matmul_precision("highest"):
        jacc, jinfo = jlinear_probe.main(_command_argv(tmp_path / "jax", yaml, clip_swin_ckpt,
                                                       *options, text_head=False))
    pacc, pinfo = plinear_probe.main(_command_argv(tmp_path / "port", yaml, clip_swin_ckpt,
                                                   *options, device=("--device", "cpu"),
                                                   text_head=False))
    assert pacc == jacc
    for key in ("n_trainable_params", "n_params", "n_visual_params", "n_backbone_params"):
        assert pinfo[key] == jinfo[key], key
    (gj, gtxt), (wj, wtxt) = (_predictions(tmp_path / "port", "linear_probe_5"),
                              _predictions(tmp_path / "jax", "linear_probe_5"))
    gp, wp = np.asarray(gj.pop("predictions")), np.asarray(wj.pop("predictions"))
    assert gp.shape == wp.shape == (1, 160, 10)
    assert np.abs(gp - wp).max() <= TOL
    assert gj == wj and gtxt == wtxt


def test_finetune_on_clip_swin_runs_the_train_mode_forward(monkeypatch, tmp_path,
                                                           clip_swin_ckpt):
    """CLIP-Swin's get_model consumes no DROP_PATH_RATE (the reference's
    clip_swin branch builds no stochastic forward), so finetune trains the
    tower through its one forward; cls_swin with DROP_PATH_RATE goes
    through forward_features_train, drawing from the step's generator."""
    monkeypatch.chdir(REPO)
    yaml = toy_clip_swin_yaml(tmp_path)
    acc, info = pfinetune.main(_command_argv(tmp_path / "ft", yaml, clip_swin_ckpt,
                                             "--no-tuning", "True", "--lr", "0.001", "--l2",
                                             "0.0001", device=("--device", "cpu")))
    preds = np.asarray(_predictions(tmp_path / "ft", "finetuning_5")[0]["predictions"])
    assert preds.shape == (1, 160, 10) and np.isfinite(preds).all()
    assert info["n_trainable_params"] > info["n_visual_params"] // 2

    from pevit_tpu_torch.train import TrainTask

    calls = []
    real = TrainTask.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        fwd = self._forward_fn

        def counted(p, x, train, generator=None, trials=0):
            calls.append((train, generator is not None))
            return fwd(p, x, train, generator, trials=trials)

        self._forward_fn = counted

    monkeypatch.setattr(TrainTask, "__init__", spy)
    cls_yaml = tmp_path / "toy_cls_swin.yaml"
    cls_yaml.write_text("MODEL:\n  NAME: cls_swin_tiny\n  SPEC:\n    EMBED_DIM: 16\n"
                        "    DEPTHS: [2, 2]\n    NUM_HEADS: [2, 2]\n    WINDOW_SIZE: 4\n"
                        "    DROP_PATH_RATE: 0.1\n")
    argv = _command_argv(tmp_path / "cls", str(cls_yaml), "", "--no-tuning", "True",
                         "--lr", "0.001", "--l2", "0.0001", device=("--device", "cpu"))
    pfinetune.main(argv)
    assert (True, True) in calls and (False, False) in calls
