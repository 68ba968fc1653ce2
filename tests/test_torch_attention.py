"""Port's attention plain version against the reference's XLA core and its
Pallas kernel (interpret mode), rtol 1e-4 / atol 1e-5 as the reference's own
kernel test.  B*H = 3, 6 and 12 are not multiples of the Pallas kernel's
8 (batch, head) pairs per program, so its padding is exercised too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pevit_tpu.ops import attention as ja
from pevit_tpu_torch.ops import attention as ta

TOL = dict(rtol=1e-4, atol=1e-5)
BH = [(1, 3), (2, 3), (3, 4)]


def _qkv(b, h, n, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    q = (0.1 * rng.standard_normal((b, h, n, hd))).astype(np.float32)
    k = (0.1 * rng.standard_normal((b, h, n, hd))).astype(np.float32)
    v = rng.standard_normal((b, h, n, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,h", BH)
@pytest.mark.parametrize("n", [5, 50, 197])
def test_ref_matches_xla_attention(b, h, n):
    q, k, v = _qkv(b, h, n)
    want = ja._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = ta.attention_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,h", BH)
@pytest.mark.parametrize("n", [5, 50, 197])
def test_ref_matches_pallas_kernel(b, h, n):
    q, k, v = _qkv(b, h, n, seed=1)
    want = ja._fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)  # interpret mode
    got = ta.attention_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [5, 50])
def test_core_bnhd_matches_reference_core(n):
    """attention_core takes (B, N, H, hd), as the reference's does."""
    q, k, v = (x.transpose(0, 2, 1, 3).copy() for x in _qkv(2, 3, n, seed=2))
    want = ja.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = ta.attention_core(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel never falls back: CPU tensors are refused, not computed."""
    q, k, v = map(torch.from_numpy, (x.transpose(0, 2, 1, 3).copy() for x in _qkv(1, 2, 5)))
    before = ta.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ta.attention_fwd(q, k, v)
    assert ta.KERNEL.launches == before


def test_core_refuses_other_devices():
    q = torch.zeros(1, 5, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ta.attention_core(q, q, q)


# ---------------------------------------------------------------------------
# the kernel's layout requirement, held to every caller's views
# ---------------------------------------------------------------------------

# (offset in bytes, (batch, token, head) strides in elements, itemsize, ok):
# the k and v views of a packed (B, 50, 3 * 768) qkv projection, and breaks
PACKED = (50 * 2304, 2304, 64)


@pytest.mark.parametrize("offset,strides,itemsize,ok", [
    (0, PACKED, 4, True), (768 * 4, PACKED, 4, True), (1536 * 2, PACKED, 2, True),
    (0, (50 * 768, 768, 64), 2, True), (4, PACKED, 4, False), (8, PACKED, 2, False),
    (0, (50 * 2306, 2306, 64), 4, False), (0, (50 * 2300, 2300, 64), 2, False),
    (0, (50 * 2300, 2300, 64), 4, True), (0, (2304, 2304, 66), 4, False),
])
def test_rows_aligned(offset, strides, itemsize, ok):
    assert ta.rows_aligned(offset, strides, itemsize) is ok


class _OperatorSpy(TorchDispatchMode):
    """The operands each of the port's kernel operators receives, as the
    operator receives them (views and all)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name.startswith("pevit_tpu_torch::"):
            self.calls.append((func._schema.name.split("::")[1], args))
        return func(*args, **(kwargs or {}))


def _tiny_serving_task(dtype: str, method: str = "kadaptation", res: int = 64, patch: int = 16):
    from pevit_tpu_torch.core import clip as pc
    from pevit_tpu_torch.peft import PeftConfig, init_peft
    from pevit_tpu_torch.train import init_bn_state, init_head, partition, trainable_pred
    from pevit_tpu_torch.train.trainer import TaskStatic

    gen = torch.Generator().manual_seed(0)
    spec = pc.CLIPSpec(embed_dim=32,
                       vision=pc.VisionSpec(input_resolution=res, patch_size=patch, width=128,
                                            layers=2, heads=2, output_dim=32),
                       text=pc.TextSpec(context_length=8, vocab_size=64, width=32, heads=2,
                                        layers=1, output_dim=32))
    cfg = PeftConfig(method=method)
    static = TaskStatic(spec=spec, peft_cfg=cfg, num_classes=5, compute_dtype=dtype)
    peft = init_peft(gen, cfg, spec, device="cpu")
    for layer in peft.layers if method == "kadaptation" else ():
        for name in ("q_left", "q_right", "v_left", "v_right"):  # live factors: deltas added
            getattr(layer, name).data.normal_(generator=gen)
    bundle = {"clip": pc.init_clip_params(gen, spec, device="cpu"), "peft": peft,
              "head": init_head(gen, static.head_dim, static.num_classes, device="cpu")}
    trainable, frozen = partition(bundle, trainable_pred(static))
    preproc = {"mean": torch.tensor([0.5, 0.4, 0.3]), "std": torch.tensor([0.2, 0.3, 0.25])}
    return static, trainable, frozen, init_bn_state(static.head_dim, device="cpu"), preproc


def _serving_forward(dtype, res: int = 64, patch: int = 16):
    from pevit_tpu_torch.serve import make_serving_fn

    serve = make_serving_fn(*_tiny_serving_task(dtype, res=res, patch=patch), device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (3, res, res, 3), dtype=np.uint8)
    return lambda: serve(images)


def _exported_forward():
    from pevit_tpu_torch.serve import export_classifier, exported_callable

    program = export_classifier(*_tiny_serving_task("float32"), image_size=64, device="cpu")
    call = exported_callable(program, None, device="cpu")
    images = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8))
    return lambda: call(images)


def _timm_vit_forward(width: int = 128):
    from pevit_tpu_torch.models import vit as pv

    spec = pv.ViTSpec(input_resolution=32, patch_size=16, width=width, layers=2, heads=2)
    vit = pv.init_vit_params(torch.Generator().manual_seed(2), spec, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 32, 32, 3), np.float32))
    return lambda: pv.vit_forward_features(vit, x, spec=spec)


def _declip_tower_forward():
    from pevit_tpu_torch.core import clip as pc
    from pevit_tpu_torch.models import declip as pd

    spec = pd.DeclipSpec(embed_dim=16,
                         vision=pc.VisionSpec(input_resolution=64, patch_size=32, width=128,
                                              layers=2, heads=2, output_dim=16),
                         text=pc.TextSpec(context_length=8, vocab_size=64, width=32, heads=2,
                                          layers=1, output_dim=16))
    model = pd.init_declip_params(torch.Generator().manual_seed(3), spec, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 64, 64, 3), np.float32))
    return lambda: pd.encode_image(model, x, spec=spec, use_fused_mlp=True)


CALLERS = {"clip_block_fp32": lambda: _serving_forward("float32"),
           "clip_block_bf16": lambda: _serving_forward("bfloat16"),
           # N = 290, past the 257 tokens of ViT-L/14 at 224 px
           "clip_block_bf16_long_seq": lambda: _serving_forward("bfloat16", res=68, patch=4),
           "timm_vit": _timm_vit_forward, "declip_tower": _declip_tower_forward,
           # heads of 80, MAE ViT-H/14's width (the fp32 body built for 80)
           "timm_vit_hd80": lambda: _timm_vit_forward(width=160),
           "exported_fp32": _exported_forward}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_every_caller_hands_the_kernels_aligned_rows(caller):
    """Run on the CPU, a path hands the operators the same views it hands
    them on the card: each attention call's q, k and v, at the caller's own
    head width, must be handed to the kernel as they are (a head width in
    whole 16-byte chunks, which the wrapper need not pad) and pass
    :func:`rows_aligned` (the kernel raises otherwise), and each fused-MLP
    call's weight matrices must be 16-byte aligned."""
    forward = CALLERS[caller]()
    with torch.no_grad(), _OperatorSpy() as spy:
        forward()
    attention = [args for name, args in spy.calls if name == "attention_fwd"]
    assert len(attention) == 2, spy.calls  # one a block
    # k is a strided view of the packed qkv projection, as the block leaves it
    assert all(not k.is_contiguous() for q, k, v in attention)
    for q, k, v in attention:
        for t in (q, k, v):
            B, N, H, hd = t.shape
            assert ta.launch_plan(B, N, H, hd, t.dtype).hd == hd and t.stride(-1) == 1
            assert ta.rows_aligned(t.data_ptr(), t.stride()[:3], t.element_size()), \
                (caller, t.shape, t.stride(), t.data_ptr() % 16)
    mlp = [args for name, args in spy.calls if name == "fused_mlp_fwd"]
    assert len(mlp) == (0 if caller.startswith("timm_vit") else 2)
    for x, ln_s, ln_b, wfc, bfc, wproj, bproj, eps in mlp:
        assert wfc.data_ptr() % 16 == 0 and wproj.data_ptr() % 16 == 0


def _train_step(method: str, dtype: str):
    """One train step (an epoch of one batch) of a tiny task, as
    ``build_epoch_fn`` runs it: forward, loss, autograd and the update."""
    from pevit_tpu_torch.train import (TrainState, build_epoch_fn, combine, make_optimizer,
                                       trainable_params)

    static, trainable, frozen, bn, preproc = _tiny_serving_task(dtype, method)
    params = trainable_params(trainable)
    opt_init, _ = make_optimizer(static.optimizer, momentum=static.momentum,
                                 nesterov=static.nesterov)
    state = TrainState(params, opt_init(params), bn, torch.Generator().manual_seed(0))
    images = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    labels = torch.tensor([0, 1, 2, 3])
    epoch = build_epoch_fn(static, len(labels), preproc)
    return lambda: epoch(combine(trainable, frozen), images, labels, state, 0.01, 1e-4)


@pytest.mark.parametrize("method,dtype", [("kadaptation", "float32"), ("lora", "float32"),
                                          ("kadaptation", "bfloat16")])
def test_every_train_step_hands_the_mlp_backward_aligned_operands(method, dtype):
    """Run on the CPU, a train step hands the fused-MLP backward operator the
    tensors it hands it on the card: dy, x, wfc and wproj contiguous and
    16-byte aligned (the kernel copies 16-byte chunks of each and raises
    otherwise, in both bodies), one call a block."""
    step = _train_step(method, dtype)
    with _OperatorSpy() as spy:
        step()
    bwd = [args for name, args in spy.calls if name == "fused_mlp_bwd"]
    assert len(bwd) == 2, [name for name, _ in spy.calls]  # one a block
    for dy, x, ln_s, ln_b, wfc, bfc, wproj, eps in bwd:
        assert dy.dtype == x.dtype == wfc.dtype == getattr(torch, dtype)
        for t in (dy, x, wfc, wproj):
            assert t.is_contiguous() and t.data_ptr() % 16 == 0, \
                (method, dtype, tuple(t.shape), t.stride(), t.data_ptr() % 16)
