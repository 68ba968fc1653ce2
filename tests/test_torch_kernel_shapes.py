"""The kernels at every shape the reference's kernels take, held on the CPU:

* the plain attention (``attention_ref``) against the reference's Pallas
  kernel in interpret mode at head widths 20, 32, 80 (MAE ViT-H/14) and
  128: float32 at rtol 1e-5 / atol 1e-6, bfloat16 by the same-rounding rule
  of ``test_torch_bf16_rounding`` (one bf16 ulp, at most 1% of the elements
  differing);
* the plain fused-MLP forward and backward against ``_pallas_fwd`` /
  ``_pallas_bwd`` in interpret mode at C = 200 (a width that fills no
  tile), 320 and 1280 (ViT-H), F = 4C: float32 at the reference test's
  2e-5, bfloat16 by the same-rounding rule;
* the pure launch plans: every hd from 1 to 256 in both dtypes and a sweep
  of (C, F) give a plan and no ``KernelInputError``; ``check_grid`` counts
  the blocks of the body that runs; every scratch region starts 16-byte
  aligned; the wrappers' zero-padding of a width that fills no 16-byte
  chunk computes the unpadded MLP and its backward (float64);
* K1's bf16 body with the S tile in shared memory, with its four-stage
  and its short ring: which body runs at each (N, W) and its grid, each
  ring's longest N (and the persistent body's and the register body's,
  whose routing ``test_torch_attention_tma.py`` holds) mirrored from
  ``attention_fwd.cu``, where ``static_assert``s hold each layout within
  the card's 232,448 bytes a block;
* both model families at toy width against the reference at 1e-5: a timm
  ViT with heads of 80 (EMBED_DIM 160, NUM_HEADS 2, DEPTH 2) from its
  MODEL.SPEC, its features and its first-step ``full_finetune``
  gradients; a CLIP tower of width 320 (5 heads of 64, outside the four
  widths the kernels once took), one KAdaptation step.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.core import clip as jc
from pevit_tpu.models import get_model as jax_get_model
from pevit_tpu.ops import attention as ja
from pevit_tpu.ops.fused_mlp import fused_mlp_residual as jax_fused
from pevit_tpu.peft import PeftConfig
from pevit_tpu.train import trainer as jt
from pevit_tpu_torch import bridge
from pevit_tpu_torch.core import clip as pc
from pevit_tpu_torch.models import get_model
from pevit_tpu_torch.ops import attention as ta
from pevit_tpu_torch.ops import fused_mlp as tf
from pevit_tpu_torch.ops._build import CSRC, KernelInputError
from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig
from pevit_tpu_torch.train import TaskStatic, TrainTask, model_forward, partition
from pevit_tpu_torch.train import trainable_params, trainable_pred
from pevit_tpu_torch.train.trainer import _loss

from .test_torch_attention_long_seq import kadaptation_step_matches
from .test_torch_bf16_rounding import _assert_same_rounding, _bf16, _jax, _numpy
from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)
from .test_torch_factory import listless, pair
from .test_torch_trainer import _flat

TOL = 1e-5
HEAD_DIMS = [20, 32, 80, 128]
MLP_WIDTHS = [200, 320, 1280]
NAMES = ("ln_scale", "ln_bias", "wfc", "bfc", "wproj", "bproj")


# ---------------------------------------------------------------------------
# the plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------

def _qkv(hd, n, seed):
    """q, k, v (1, 2, n, hd) with logits of std 0.5 at every head width."""
    rng = np.random.default_rng(seed)
    s = (0.25 / hd) ** 0.25
    return tuple((scale * rng.standard_normal((1, 2, n, hd))).astype(np.float32)
                 for scale in (s, s, 1.0))


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_attention_ref_matches_pallas_kernel_at_head_widths(hd):
    q, k, v = _qkv(hd, 50, seed=hd)
    want = ja._pallas_forward(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = ta.attention_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_attention_ref_bf16_matches_pallas_kernel_at_head_widths(hd):
    """In bfloat16 the reference pads hd 20 to 24 for its lanes; the port's
    wrapper pads it for its 16-byte copies: zero columns change nothing."""
    q, k, v = (_bf16(t) for t in _qkv(hd, 50, seed=hd + 1))
    want = _numpy(ja._pallas_forward(_jax(q), _jax(k), _jax(v), interpret=True))
    got = ta.attention_ref(q, k, v)
    assert got.dtype == torch.bfloat16
    _assert_same_rounding(got, want)


def _mlp_params(c, seed):
    rng = np.random.default_rng(seed)
    f = 4 * c
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"ln_scale": 1.0 + 0.1 * r(c), "ln_bias": 0.1 * r(c), "wfc": r(c, f) * c ** -0.5,
            "bfc": 0.1 * r(f), "wproj": r(f, c) * f ** -0.5, "bproj": 0.1 * r(c)}


def _mlp_case(c, dtype, seed):
    """x, dy (2, 5, C) and the weights, as torch tensors of ``dtype`` (the
    LayerNorm's float32) and as the reference's arrays."""
    rng = np.random.default_rng(seed)
    p = _mlp_params(c, seed)
    cast = (lambda a: torch.from_numpy(a)) if dtype == torch.float32 else _bf16
    w = [torch.from_numpy(p[n]) if n.startswith("ln") else cast(p[n]) for n in NAMES]
    x, dy = (cast(rng.standard_normal((2, 5, c)).astype(np.float32)) for _ in range(2))
    return x, dy, w, [_jax(t) for t in w]


@pytest.mark.parametrize("c", MLP_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_mlp_refs_match_pallas_kernels_at_widths(c, dtype):
    x, dy, w, jw = _mlp_case(c, dtype, seed=c)
    want_y = jax_fused(_jax(x), *jw, True)  # interpret mode
    _, vjp = jax.vjp(lambda xx: jax_fused(xx, *jw, True), _jax(x))
    (want_dx,) = vjp(_jax(dy))
    got_y = tf.fused_mlp_residual_ref(x, *w)
    got_dx = tf.fused_mlp_bwd_ref(dy, x, *w[:-1])
    if dtype == torch.float32:
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), rtol=2e-5, atol=2e-5)
    else:
        _assert_same_rounding(got_y, _numpy(want_y))
        _assert_same_rounding(got_dx, _numpy(want_dx))


# ---------------------------------------------------------------------------
# the launch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_every_head_width_has_a_launch_plan(dtype):
    """hd 1 to 256 at every body's sequence lengths: hd padded to whole
    16-byte chunks only where it does not fill them, the instantiation the
    next built width, the bf16 persistent body only for bf16 at N <= 257
    and hd <= 64, the fp32 persistent body for fp32 at hd <= 64 (every N),
    and the grid of the body that runs (a persistent body's one block an SM
    at most)."""
    chunk = 128 // torch.finfo(dtype).bits  # elements in 16 bytes
    for hd in range(1, ta.MAX_HEAD_DIM + 1):
        for n in (1, 50, 197, 257, 258, 577, 640, 641, 730, 768, 769, 1025, 1280, 1281):
            plan = ta.launch_plan(3, n, 5, hd, dtype)
            assert plan.hd % chunk == 0 and hd <= plan.hd < hd + chunk
            assert plan.width == min(w for w in ta.BODY_WIDTHS if w >= plan.hd)
            bf16 = dtype == torch.bfloat16
            tma = bf16 and n <= ta.TMA_MAX_SEQ and plan.hd <= 64
            tiled = bf16 and not tma and plan.hd <= 64  # a shared-memory body
            in_smem = tiled and n <= ta.SMEM_MAX_SEQ
            in_smem2 = tiled and ta.SMEM_MAX_SEQ < n <= ta.SMEM2_MAX_SEQ
            f32_tma = not bf16 and plan.hd <= ta.F32_TMA_WIDTH
            assert plan.body == ("bf16_tma" if tma else
                                 "bf16_smem" if in_smem else "bf16_smem2" if in_smem2 else
                                 "bf16_long" if bf16 else "f32_tma" if f32_tma else "f32")
            one = in_smem or in_smem2 or f32_tma
            columns = 1 if one else -(-plan.hd // min(plan.width, ta.COLUMN_CHUNK))
            assert columns == (2 if plan.hd > 128 and not one else 1)
            per_head = 1 if tma else -(-n // ta.QUERY_TILE) * columns
            jobs = 15 * -(-per_head // 2)  # the fp32 body's jobs: two query tiles each
            assert plan.blocks == (min(15, ta.H100_SMS) if tma else
                                   min(jobs, ta.H100_SMS) if f32_tma else 15 * per_head)
    for hd in (0, ta.MAX_HEAD_DIM + 1):
        with pytest.raises(KernelInputError, match="hd"):
            ta.launch_plan(1, 5, 1, hd, dtype)


@pytest.mark.parametrize("n,hd,dtype,blocks_per_head", [
    (197, 64, torch.bfloat16, 1), (197, 80, torch.bfloat16, 4), (197, 80, torch.float32, 4),
    (577, 64, torch.bfloat16, 10), (641, 64, torch.bfloat16, 11), (577, 256, torch.bfloat16, 20),
    (257, 200, torch.float32, 10), (50, 20, torch.bfloat16, 1), (730, 64, torch.bfloat16, 12),
    (768, 64, torch.bfloat16, 12), (769, 64, torch.bfloat16, 13),
    (1025, 64, torch.bfloat16, 17), (1281, 64, torch.bfloat16, 21),
    (50, 64, torch.float32, 1), (257, 32, torch.float32, 5), (577, 96, torch.float32, 10)])
def test_check_grid_counts_the_body_that_runs(n, hd, dtype, blocks_per_head):
    """The largest batch of 16 heads a launch takes, and one more image
    (the persistent bodies count their work items: fp32's a (batch, head,
    query tile))."""
    B = ta.MAX_BLOCKS // (16 * blocks_per_head)
    ta.check_grid(B, 16, n, dtype, hd)
    with pytest.raises(KernelInputError, match="blocks"):
        ta.check_grid(B + 1, 16, n, dtype, hd)


SMEM_LIMIT = 640


@pytest.mark.parametrize("width", ta.BODY_WIDTHS)
def test_smem_body_fits_every_length_it_takes(width):
    """The launch plan sends bf16 heads of up to 64 past the persistent
    body and up to the shared-memory body's limit to that body, with one
    block a (batch, head, query tile), and N past it to the three-walk body;
    wider heads run the three-walk body at every N past the persistent
    body's."""
    limit = ta.SMEM_MAX_SEQ
    assert limit == SMEM_LIMIT
    for n in (ta.TMA_MAX_SEQ + 1, 577, limit - 1, limit):
        plan = ta.launch_plan(2, n, 3, width, torch.bfloat16)
        if width == ta.REG_WIDTH:
            assert (plan.body, plan.blocks) == ("bf16_smem", 6 * -(-n // ta.QUERY_TILE))
        else:
            assert plan.body == "bf16_long"
    columns = 2 if width > ta.COLUMN_CHUNK else 1
    for n in (1, ta.TMA_MAX_SEQ, limit + 1):
        plan = ta.launch_plan(2, n, 3, width, torch.bfloat16)
        if width == ta.REG_WIDTH and n <= ta.TMA_MAX_SEQ:  # the persistent body
            assert (plan.body, plan.blocks) == ("bf16_tma", 6)
        elif width == ta.REG_WIDTH:  # past the limit, the short ring
            assert (plan.body, plan.blocks) == ("bf16_smem2", 6 * -(-n // 64))
        else:
            assert (plan.body, plan.blocks) == ("bf16_long", 6 * -(-n // 64) * columns)


def _cu_constant(text: str, name: str) -> int:
    """A ``constexpr int`` of the source set to a number."""
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", text)
    return int(value)


def test_smem_body_mirror_matches_the_source():
    """``ops/attention.py``'s mirrors of the shared-memory bodies' longest
    N (with each ring) and of the persistent body's hold the
    source's constants, and the source holds each layout within the card's
    shared memory at its longest N."""
    text = " ".join((CSRC / "attention_fwd.cu").read_text().split())  # one space a gap
    assert _cu_constant(text, "TMA_MAX_SEQ") == ta.TMA_MAX_SEQ
    assert _cu_constant(text, "SMEM_MAX_SEQ") == ta.SMEM_MAX_SEQ
    assert _cu_constant(text, "SMEM2_MAX_SEQ") == ta.SMEM2_MAX_SEQ
    assert _cu_constant((CSRC / "tma.cuh").read_text(), "SMEM_BUDGET") == 232448
    assert "static_assert(SmemBody::bytes(SMEM_MAX_SEQ, RING) <= SMEM_BUDGET" in text
    assert "static_assert(SmemBody::bytes(SMEM2_MAX_SEQ, SHORT_RING) <= SMEM_BUDGET" in text


SHORT_RING_LIMIT = 768


@pytest.mark.parametrize("width", ta.BODY_WIDTHS)
def test_launch_plan_picks_the_short_ring_exactly_where_it_runs(width):
    """bf16 heads of up to 64 from SMEM_MAX_SEQ + 1 (641) to the short
    ring's limit (768, which takes CLIP ViT-H/14 at 378 px: N = 730) run it,
    with one block a (batch, head, query tile), and nothing else does: past
    it the three-walk body runs; fp32 never (its persistent body up to hd
    64, its mma.sync body beyond)."""
    assert ta.SMEM2_MAX_SEQ == SHORT_RING_LIMIT
    columns = 2 if width > ta.COLUMN_CHUNK else 1
    for n in range(ta.TMA_MAX_SEQ + 1, 1282):
        plan = ta.launch_plan(2, n, 3, width, torch.bfloat16)
        short = width == ta.REG_WIDTH and ta.SMEM_MAX_SEQ < n <= ta.SMEM2_MAX_SEQ
        assert (plan.body == "bf16_smem2") == short, (n, plan)
        if short:
            assert plan.blocks == 6 * -(-n // ta.QUERY_TILE)
        elif n > ta.SMEM2_MAX_SEQ or width > ta.REG_WIDTH:
            assert (plan.body, plan.blocks) == ("bf16_long", 6 * -(-n // 64) * columns)
        assert ta.launch_plan(2, n, 3, width, torch.float32).body == (
            "f32_tma" if width <= ta.F32_TMA_WIDTH else "f32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_every_width_has_a_plan_and_aligned_scratch(dtype):
    """Any C and F run at widths of whole 16-byte rows, and every region of
    both launches' scratch starts 16-byte aligned."""
    chunk = 128 // torch.finfo(dtype).bits  # elements in 16 bytes
    for c in list(range(1, 70)) + list(range(70, 2200, 37)):
        for f in (1, c, 4 * c, 4 * c + 3):
            cp, fp = tf.padded_widths(dtype, c, f)
            assert cp % chunk == 0 and c <= cp < c + chunk
            assert fp % chunk == 0 and f <= fp < f + chunk
            for layout in (tf.fwd_workspace_layout, tf.bwd_workspace_layout):
                for rows in (1, 7, 400):
                    regions = layout(dtype, rows, cp, fp)
                    assert all(offset % 16 == 0 for _, offset, _ in regions)
                    ends = [offset + size for _, offset, size in regions]
                    assert all(e <= o for e, (_, o, _) in zip(ends, regions[1:]))


def _mlp64(x, w, count, dy=None):
    """The kernels' float64 arithmetic on (R, C') rows: the LayerNorm over
    the first ``count`` columns, everything else over all of them; y, or
    dx where ``dy`` is given."""
    ln_s, ln_b, wfc, bfc, wproj, bproj = w
    mean = x[:, :count].mean(-1, keepdim=True)
    rstd = torch.rsqrt((x[:, :count] - mean).square().mean(-1, keepdim=True) + 1e-5)
    xhat = (x - mean) * rstd
    h = (xhat * ln_s + ln_b) @ wfc + bfc
    sig = torch.sigmoid(1.702 * h)
    if dy is None:
        return x + (h * sig) @ wproj + bproj
    dxhat = ((dy @ wproj.T) * (sig * (1 + 1.702 * h * (1 - sig))) @ wfc.T) * ln_s
    mdx = dxhat[:, :count].mean(-1, keepdim=True)
    mdxx = (dxhat * xhat)[:, :count].mean(-1, keepdim=True)
    return (dxhat - mdx - xhat * mdxx) * rstd + dy


@pytest.mark.parametrize("c,f", [(100, 300), (13, 7), (8, 301), (1, 1)])
def test_padding_computes_the_unpadded_mlp(c, f):
    """The wrappers' zero-padding (``_padded``) to whole 16-byte rows, run
    through the kernels' arithmetic with the LayerNorm counting the caller's
    C, gives the unpadded forward and backward in every column it keeps."""
    rng = np.random.default_rng(c + f)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s))
    w = {"ln_scale": 1 + 0.1 * r(c), "ln_bias": 0.1 * r(c), "wfc": r(c, f) * c ** -0.5,
         "bfc": 0.1 * r(f), "wproj": r(f, c) * f ** -0.5, "bproj": 0.1 * r(c)}
    x, dy = r(6, c), r(6, c)
    cp, fp = tf.padded_widths(torch.bfloat16, c, f)
    (xp, dyp), wp = tf._padded((x, dy), w, c, f, cp, fp)
    assert xp.shape == (6, cp) and wp["wfc"].shape == (cp, fp) and wp["wproj"].shape == (fp, cp)
    ordered = [w[n] for n in NAMES]
    padded = [wp[n] for n in NAMES]
    torch.testing.assert_close(_mlp64(xp, padded, c)[:, :c], _mlp64(x, ordered, c),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(_mlp64(xp, padded, c, dyp)[:, :c], _mlp64(x, ordered, c, dy),
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the model families at the new widths against the reference
# ---------------------------------------------------------------------------

def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= TOL * scale, f"{what}: max err {err} > {TOL} * {scale}"


K, B, RES = 4, 6, 32


def _hd80_pair():
    """A timm-style MAE ViT from MODEL.SPEC with heads of 80 (EMBED_DIM
    160, NUM_HEADS 2, DEPTH 2), in both packages, fp32, at 32 px."""
    cfgs = []
    for cfg in pair("mae_vitb16", res=RES):
        cfg.defrost()
        cfg.MODEL.SPEC.EMBED_DIM, cfg.MODEL.SPEC.NUM_HEADS, cfg.MODEL.SPEC.DEPTH = 160, 2, 2
        cfg.DATASET.NUM_CLASSES = K
        cfg.TRAIN.BATCH_SIZE_PER_GPU = B
        cfg.TEST.METRIC = ""
        cfg.TPU.PARITY_FP32 = True
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.freeze()
        cfgs.append(cfg)
    jcfg, pcfg = cfgs
    jb = jax_get_model(jcfg)
    pb = get_model(pcfg, device="cpu")
    bridge.module_from_jax(jax.tree.map(np.asarray, jb.params), pb.params, device="cpu")
    return jcfg, pcfg, jb, pb


def test_a_vit_with_heads_of_80_matches_the_reference():
    """Features and first-step ``full_finetune`` gradients.  The head's
    train-mode BN cancels the final LayerNorm's bias gradient and divides
    its scale's out up to the BN's eps (~1e-6 of the tree's largest here,
    mostly rounding): those two are held to the tree's largest magnitude."""
    jcfg, pcfg, jb, pb = _hd80_pair()
    assert pb.feat_dim == 160 and pcfg.MODEL.SPEC.EMBED_DIM // pcfg.MODEL.SPEC.NUM_HEADS == 80
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, RES, RES, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jb.forward_features(jb.params, jnp.asarray(x))
    _close(pb.forward_features(pb.params, torch.from_numpy(x)).detach().numpy(), want,
           "features")

    jstatic = jt.TaskStatic.from_config(jcfg, jc.CLIPSpec.from_config(jcfg),
                                        PeftConfig(method="full_finetune"), feat_dim=jb.feat_dim)
    jtask = jt.TrainTask(jcfg, jstatic, None, backbone=jb, eval_chunk=64)
    trainable, frozen, bn = jtask.init_bundle(jax.random.PRNGKey(1))
    images = rng.integers(0, 256, (B, RES, RES, 3), dtype=np.uint8)
    labels = rng.integers(0, K, (B,)).astype(np.int32)
    ones = jnp.ones((B,), jnp.float32)

    def loss_fn(tr):
        logits, _ = jt.model_forward(jstatic, jt.combine(tr, frozen), bn, jnp.asarray(images),
                                     jtask.preproc, train=True, rng=jax.random.PRNGKey(5),
                                     mask=ones, forward_fn=jtask._forward_fn)
        return jt._loss(jstatic, logits, jnp.asarray(labels), ones)

    with jax.default_matmul_precision("highest"):
        want_grads = jax.jit(jax.grad(loss_fn))(trainable)

    peft = PortPeftConfig(method="full_finetune")
    pstatic = TaskStatic.from_config(pcfg, pc.CLIPSpec.from_config(pcfg), peft,
                                     feat_dim=pb.feat_dim)
    ptask = TrainTask(pcfg, pstatic, None, device="cpu", backbone=pb, eval_chunk=64)
    bundle, bn_t = bridge.from_jax(jax.tree.map(np.asarray, jt.combine(trainable, frozen)),
                                   jax.tree.map(np.asarray, bn), pstatic.spec, peft,
                                   device="cpu", backbone=ptask.clip)
    params = trainable_params(partition(bundle, trainable_pred(pstatic))[0])
    valid = torch.ones(B)
    logits, _ = model_forward(pstatic, bundle, bn_t, torch.from_numpy(images), ptask.preproc,
                              train=True, mask=valid, forward_fn=ptask._forward_fn)
    loss = _loss(pstatic, logits, torch.from_numpy(labels).long(), valid)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    got = _flat(listless(bridge._tree_to_jax({n: torch.zeros_like(p) if g is None else g
                                              for (n, p), g in zip(params.items(), grads)})))
    want = _flat(listless(jax.tree.map(np.asarray, want_grads)))
    assert got.keys() == want.keys() and any(k.startswith("clip.") for k in want)
    largest = max(float(np.abs(v).max()) for v in want.values())
    for name in want:
        if name in ("clip.norm.bias", "clip.norm.scale"):
            assert float(np.abs(got[name] - want[name]).max()) <= TOL * largest, name
            continue
        assert np.any(want[name]), name
        _close(got[name], want[name], f"grad {name}")


def test_a_kadaptation_step_on_a_tower_of_width_320():
    """Vision width 320: 5 heads of 64, outside the four widths the fused
    MLP once took (K2 and K3's plain versions on the CPU, at C = 320)."""
    tiny = jc.CLIPSpec(
        embed_dim=32,
        vision=jc.VisionSpec(input_resolution=32, patch_size=16, width=320, layers=2, heads=5,
                             output_dim=32),
        text=jc.TextSpec(context_length=8, vocab_size=64, width=32, heads=2, layers=1,
                         output_dim=32))
    port_tiny = pc.CLIPSpec(embed_dim=tiny.embed_dim,
                            vision=pc.VisionSpec(**dataclasses.asdict(tiny.vision)),
                            text=pc.TextSpec(**dataclasses.asdict(tiny.text)))
    # at ten times the 290-token tower's rate, so that every factor moves
    # by far more than the tolerance in one step
    kadaptation_step_matches(tiny, port_tiny, lr=0.1)
