"""Sequences longer than 257 tokens, the port against the reference, on the
CPU at toy width:

* the plain attention at N = 258, 577 (CLIP ViT-L/14 at 336 px), 641 (the
  short ring's first), 730 (CLIP ViT-H/14 at 378 px), 769 (the three-walk
  body's first at hd 64) and 1025 against the reference's Pallas kernel in
  interpret mode, float32 at rtol 1e-5 / atol 1e-6
  (``test_torch_bf16_rounding.py`` holds the bf16 rounding point at these
  lengths); and in bfloat16, by that file's same-rounding rule, at every
  head width at the longest N of K1's shared-memory body with its four-stage
  ring (hd <= 64) and one more, and at hd 64 at 730, the short ring's
  longest N, one more (where the three-walk body takes over) and 1025;
* a toy CLIP tower with N = 290 (68 px, patch 4, width 128, 2 layers of 2
  heads of 64): KAdaptation's eval logits and trained parameters after one
  SGD step, fp32, against the reference's ``build_fit_eval_fn``, within
  1e-5 of each one's largest magnitude;
* an OpenAI-layout state dict at toy width with a 577-row
  ``visual.positional_embedding`` loads to ``input_resolution`` 336 in both
  packages, with equal parameters, bit for bit, and one with a 730-row
  embedding to 378;
* the spec of ``chip_smoke.py``'s phase 16c (CLIP ViT-H/14 from its
  MODEL.SPEC at ``TRAIN.IMAGE_SIZE [378, 378]``) is the reference's: by the
  reference's rule (heads = width // 64) 20 heads of 64, N = 730.
"""

import argparse
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.ckpt import torch_loader as jloader
from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu.config import update_config as jax_update
from pevit_tpu.core import clip as jc
from pevit_tpu.core import CLIPSpec, TextSpec, VisionSpec, init_clip_params
from pevit_tpu.ops import attention as ja
from pevit_tpu.peft import PeftConfig
from pevit_tpu.train import optim as jo
from pevit_tpu.train import trainer as jt
from pevit_tpu.train.partition import combine as jcombine
from pevit_tpu_torch import bridge
from pevit_tpu_torch.ckpt import clip_to_state_dict, load_clip
from pevit_tpu_torch.config import get_default_config, update_config
from pevit_tpu_torch.core import clip as port_clip
from pevit_tpu_torch.ops import attention as ta
from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig
from pevit_tpu_torch.train import (TaskStatic, TrainState, TrainTask, build_fit_eval_fn,
                                   make_optimizer, partition, trainable_params,
                                   trainable_pred)

from .test_torch_bf16_rounding import _assert_same_rounding, _bf16, _jax, _numpy
from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)

LONG = [258, 577, 641, 730, ta.SMEM2_MAX_SEQ + 1, 1025]
# the lengths at hd 64 past the four-stage ring's (whose first, 641, the
# widths' cases take): CLIP ViT-H/14 at 378 px, the short ring's last and
# one more (the three-walk body's first), 1025
SHORT_RING_LENGTHS = [730, ta.SMEM2_MAX_SEQ, ta.SMEM2_MAX_SEQ + 1, 1025]


def _qkv(n, seed):
    rng = np.random.default_rng(seed)
    return tuple((s * rng.standard_normal((1, 2, n, 64))).astype(np.float32)
                 for s in (0.1, 0.1, 1.0))


@pytest.mark.parametrize("n", LONG)
def test_ref_matches_pallas_kernel_at_long_sequences(n):
    q, k, v = _qkv(n, seed=n)
    want = ja._pallas_forward(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = ta.attention_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _bf16_qkv(width, n):
    """One image of two heads whose logits spread with std 0.5."""
    rng = np.random.default_rng(width + n)
    s = (0.25 / width) ** 0.25
    return tuple(_bf16(scale * rng.standard_normal((1, 2, n, width))) for scale in (s, s, 1.0))


@pytest.mark.parametrize("width,n", [(w, ta.SMEM_MAX_SEQ + extra)
                                     for w in ta.BODY_WIDTHS for extra in (0, 1)]
                         + [(ta.REG_WIDTH, n) for n in SHORT_RING_LENGTHS])
def test_ref_bf16_matches_pallas_kernel_at_smem_limits(width, n):
    q, k, v = _bf16_qkv(width, n)
    want = _numpy(ja._pallas_forward(_jax(q), _jax(k), _jax(v), interpret=True))
    got = ta.attention_ref(q, k, v)
    assert got.dtype == torch.bfloat16
    _assert_same_rounding(got, want)


# ---------------------------------------------------------------------------
# a toy tower with N = 290: one KAdaptation step through both packages
# ---------------------------------------------------------------------------

RES, K, B, N_VAL = 68, 4, 4, 3
LR, WD = 0.01, 1e-3
TOL = 1e-5
TINY = CLIPSpec(
    embed_dim=32,
    vision=VisionSpec(input_resolution=RES, patch_size=4, width=128, layers=2, heads=2,
                      output_dim=32),
    text=TextSpec(context_length=8, vocab_size=64, width=32, heads=2, layers=1, output_dim=32),
)
PORT_TINY = port_clip.CLIPSpec(
    embed_dim=TINY.embed_dim,
    vision=port_clip.VisionSpec(**dataclasses.asdict(TINY.vision)),
    text=port_clip.TextSpec(**dataclasses.asdict(TINY.text)),
)


def _cfg(make):
    cfg = make()
    cfg.defrost()
    cfg.DATASET.NUM_CLASSES = K
    cfg.TRAIN.BATCH_SIZE_PER_GPU = B
    cfg.TPU.PARITY_FP32 = True
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.freeze()
    return cfg


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max err {err} > {TOL} * {scale}"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_perm(key):
    """The reference fit's shuffle of its one epoch: _, perm_rng, _ = split(key, 3)."""
    _, perm_rng, _ = jax.random.split(key, 3)
    return np.asarray(jax.random.permutation(perm_rng, B))


def test_kadaptation_step_on_a_tower_of_290_tokens():
    assert PORT_TINY.vision.seq_len == 290
    kadaptation_step_matches(TINY, PORT_TINY)


def kadaptation_step_matches(tiny: CLIPSpec, port_tiny, lr: float = LR) -> None:
    """One fp32 KAdaptation SGD step at ``lr`` with live factors on the
    tower of ``tiny`` (the reference's spec) and ``port_tiny`` (the
    port's): the eval logits and every trained parameter within TOL of each
    one's largest magnitude, the reference's ``build_fit_eval_fn`` against
    the port's; every leaf the forward reads moved by more than 100 x TOL."""
    res = tiny.vision.input_resolution
    cfg = _cfg(jax_defaults)
    static = jt.TaskStatic.from_config(cfg, tiny, PeftConfig(method="kadaptation",
                                                              kadapt_dropout_p=0.0))
    task = jt.TrainTask(cfg, static, init_clip_params(jax.random.PRNGKey(0), tiny))
    trainable, frozen, bn = task.init_bundle(jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    layers = trainable["peft"]["layers"]
    for name in ("q_left", "q_right", "v_left", "v_right", "b"):  # live factors and bias
        layers[name] = jnp.asarray(0.1 * rng.standard_normal(layers[name].shape), jnp.float32)
    images = rng.integers(0, 256, (B + N_VAL, res, res, 3), dtype=np.uint8)
    labels = rng.integers(0, K, (B,)).astype(np.int32)
    train, val = images[:B], images[B:]

    fit_eval = jax.jit(jt.build_fit_eval_fn(static, B, 1, task.preproc, eval_chunk=64,
                                            n_val=N_VAL))
    opt_init, _ = jo.make_optimizer(static.optimizer, momentum=static.momentum,
                                    nesterov=static.nesterov)
    key = jax.random.PRNGKey(2)
    state, want_logits = fit_eval(frozen, task.prepack(train), jnp.asarray(labels),
                                  task.prepack(val), (trainable, opt_init(trainable), bn, key),
                                  jnp.full((1,), lr, jnp.float32), jnp.float32(WD))

    pcfg = _cfg(get_default_config)
    peft_cfg = PortPeftConfig(method="kadaptation", kadapt_dropout_p=0.0)
    pstatic = TaskStatic.from_config(pcfg, port_tiny, peft_cfg)
    bundle, bn_t = bridge.from_jax(jax.tree.map(np.asarray, jcombine(trainable, frozen)),
                                   jax.tree.map(np.asarray, bn), port_tiny, peft_cfg,
                                   device="cpu")
    ptask = TrainTask(pcfg, pstatic, bundle["clip"], device="cpu")
    params = trainable_params(partition(bundle, trainable_pred(pstatic))[0])
    p_init, _ = make_optimizer(pstatic.optimizer, momentum=pstatic.momentum,
                               nesterov=pstatic.nesterov)
    fe = build_fit_eval_fn(pstatic, B, 1, ptask.preproc, eval_chunk=64, n_val=N_VAL)
    pstate = TrainState(params, p_init(params), bn_t, torch.Generator().manual_seed(0))
    pstate, logits = fe(bundle, ptask.prepack(train), torch.from_numpy(labels).long(),
                        ptask.prepack(val), pstate, [lr], WD, orders=[_jax_perm(key)])
    assert logits.shape == (1, N_VAL, K) and torch.isfinite(pstate.loss)
    _close(logits[0].numpy(), np.asarray(want_logits[0]), "val logits after the step")
    got = _flat(bridge._tree_to_jax(params))
    want = _flat(jax.tree.map(np.asarray, state[0]))
    before = _flat(jax.tree.map(np.asarray, trainable))
    assert got.keys() == want.keys()
    for name in want:
        _close(got[name], want[name], f"trained {name}")
        if name.split(".")[-1] not in ("v_left", "v_right"):  # quirk 1: never read
            assert np.abs(want[name] - before[name]).max() > 100 * TOL * np.abs(want[name]).max()


# ---------------------------------------------------------------------------
# a 336 px OpenAI-layout state dict (N = 577)
# ---------------------------------------------------------------------------

def test_a_577_position_state_dict_loads_at_336_px_in_both_packages(tmp_path):
    loads_in_both_packages(tmp_path, "ViT-L/14@336px", 336, 577)


def test_a_730_position_state_dict_loads_at_378_px_in_both_packages(tmp_path):
    loads_in_both_packages(tmp_path, "ViT-H-14-378", 378, 730)


def loads_in_both_packages(tmp_path, name: str, res: int, tokens: int) -> None:
    """A toy OpenAI-layout state dict (patch 14, width 64) at ``res`` px:
    ``tokens`` positions, loaded to ``res`` by both packages' loaders, the
    parameters equal to each other and to the written ones bit for bit."""
    spec = port_clip.CLIPSpec(
        embed_dim=16,
        vision=port_clip.VisionSpec(input_resolution=res, patch_size=14, width=64, layers=1,
                                    heads=1, output_dim=16),
        text=port_clip.TextSpec(context_length=8, vocab_size=64, width=32, heads=2, layers=1,
                                output_dim=16))
    src = port_clip.init_clip_params(torch.Generator().manual_seed(4), spec, device="cpu")
    sd = clip_to_state_dict(src)
    assert sd["visual.positional_embedding"].shape[0] == tokens
    path = tmp_path / f"{name.replace('/', '-')}.pt"
    torch.save(sd, path)
    want_params, jspec = jloader.load_clip(name, checkpoint_path=str(path))
    clip, got_spec = load_clip(name, checkpoint_path=str(path), device="cpu")
    assert jspec.vision.input_resolution == got_spec.vision.input_resolution == res
    assert jspec.vision.seq_len == got_spec.vision.seq_len == tokens
    assert got_spec.vision == spec.vision
    want = bridge.clip_from_jax(jax.tree.map(np.asarray, want_params), got_spec, device="cpu")
    got_sd, want_sd, src_sd = clip.state_dict(), want.state_dict(), src.state_dict()
    assert got_sd.keys() == want_sd.keys() == src_sd.keys()
    for name, t in want_sd.items():
        assert torch.equal(got_sd[name], t) and torch.equal(got_sd[name], src_sd[name]), name


# ---------------------------------------------------------------------------
# phase 16c's tower: CLIP ViT-H/14 at 378 px from its MODEL.SPEC
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parents[1]


def h14_378_config(make, update):
    """``chip_smoke.clip_h14_config(378)``: the cifar-10 and ViT-B/32 YAMLs
    merged as the commands merge them, at ``TRAIN.IMAGE_SIZE [378, 378]``,
    MODEL.SPEC set to LAION's ViT-H-14 widths (vision 1280 x 32, patch 14;
    text 1024 x 24 of 16 heads; embedding 1024)."""
    cfg = make()
    opts = ["TRAIN.IMAGE_SIZE", "[378,378]"]
    for name in ("datasets/cifar10.yaml", "model/vitb32_CLIP.yaml"):
        update(cfg, argparse.Namespace(cfg=str(REPO / "resources" / name), opts=opts))
    cfg.defrost()
    cfg.MODEL.NAME = "ViT-H/14"
    spec = cfg.MODEL.SPEC
    spec.EMBED_DIM = 1024
    spec.VISION.WIDTH, spec.VISION.LAYERS, spec.VISION.PATCH_SIZE = 1280, 32, 14
    spec.TEXT.WIDTH, spec.TEXT.HEADS, spec.TEXT.LAYERS = 1024, 16, 24
    cfg.freeze()
    return cfg


def test_the_378_px_h14_spec_is_the_references():
    """20 heads of 64, not the published tower's 16 of 80: the reference's
    rule, which the port mirrors (ROADMAP section 3)."""
    want = jc.CLIPSpec.from_config(h14_378_config(jax_defaults, jax_update))
    got = port_clip.CLIPSpec.from_config(h14_378_config(get_default_config, update_config))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    v = got.vision
    assert (v.width, v.layers, v.heads, v.patch_size, v.input_resolution, v.seq_len) == \
        (1280, 32, 20, 14, 378, 730)
    plan = ta.launch_plan(64, v.seq_len, v.heads, v.width // v.heads, torch.bfloat16)
    assert plan.body == "bf16_smem2"
