"""The FLOP ledger: the port's ``utils.flops.step_flops`` against the JAX
reference's ``pevit_tpu.utils.flops.step_flops`` (2*M*N*K over the
``dot_general``s of the traced program), the operators' registered
formulas, and ``chip_peaks``.

A serving forward counts exactly what the reference counts.  A train step
counts the port's own program, which differs from the reference's in two
places, each checked by its closed form: torch's autograd computes no
gradient of the first block's input (nothing before it trains), where the
reference's layer scan runs the same backward in every layer; and the port
builds KAdaptation's shared phm rules in every layer, where the
reference's autodiff hoists their forward out of the scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pevit_tpu.ops.attention import _xla_attention_bnhd
from pevit_tpu.peft import PeftConfig
from pevit_tpu.peft.kron import batched_kron_sum as jax_kron_sum
from pevit_tpu.train import trainer as jt
from pevit_tpu.train.partition import combine as jcombine
from pevit_tpu.utils.flops import step_flops as jax_step_flops
from pevit_tpu_torch.core import CLIPSpec
from pevit_tpu_torch.core.clip import CLIP
from pevit_tpu_torch.ops.attention import attention_core
from pevit_tpu_torch.ops.fused_mlp import fused_mlp_residual
from pevit_tpu_torch.peft import PeftConfig as PortPeftConfig
from pevit_tpu_torch.peft.kadaptation import PHM_DIM, KAdaptation
from pevit_tpu_torch.peft.kron import batched_kron_sum
from pevit_tpu_torch.peft.lora import LORA_RANK
from pevit_tpu_torch.train import Head, partition, trainable_pred
from pevit_tpu_torch.train.trainer import (UNFUSED_MLP_METHODS, TaskStatic, _loss,
                                           model_forward)
from pevit_tpu_torch.utils.flops import CHIP_SPECS, chip_peaks, step_flops

from .test_torch_bridge import (  # noqa: F401  (bnhd_layout: autouse fixture)
    NUM_CLASSES, PORT_TINY, TINY, bnhd_layout, jax_bundle, port_bundle)
from .test_torch_serve import PREPROC, _images
from .test_torch_trainer import B, _data, _jax_task, _port_side, clip_params  # noqa: F401
from .test_torch_trainer import PORT_TINY as TRAIN_SPEC

METHODS = ("kadaptation", "lora", "adapter", "compacter")


@pytest.mark.parametrize("method", METHODS)
def test_serving_forward_counts_the_references_flops(method):
    bundle, bn = jax_bundle(method=method)
    static = jt.TaskStatic(spec=TINY, peft_cfg=PeftConfig(method=method),
                           num_classes=NUM_CLASSES, compute_dtype="float32", use_fused_mlp=False)
    jb = jax.tree.map(jnp.asarray, bundle)
    pre = {k: jnp.asarray(v) for k, v in PREPROC.items()}
    x = _images(8, seed=1)

    def jax_forward(b):
        return jt.model_forward(static, b, jax.tree.map(jnp.asarray, bn), jnp.asarray(x), pre,
                                train=False, rng=None, mask=None)[0]

    pstatic = TaskStatic(spec=PORT_TINY, peft_cfg=PortPeftConfig(method=method),
                         num_classes=NUM_CLASSES, compute_dtype="float32",
                         use_fused_mlp=method not in UNFUSED_MLP_METHODS)
    ported, bn_t = port_bundle(bundle, bn, method=method)
    trainable, frozen = partition(ported, trainable_pred(pstatic))
    from pevit_tpu_torch.serve import make_serving_fn

    serve = make_serving_fn(pstatic, trainable, frozen, bn_t, PREPROC, device="cpu")
    assert step_flops(serve, x) == jax_step_flops(jax_forward, jb)


def _port_step(method, trainable, frozen, bn, images, labels):
    task, static, bundle, bn_t, params = _port_side(trainable, frozen, bn, method=method)
    valid = torch.ones(len(labels))

    def step():
        logits, _ = model_forward(static, bundle, bn_t, torch.from_numpy(images), task.preproc,
                                  train=True, mask=valid)
        loss = _loss(static, logits, torch.from_numpy(labels), valid)
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)

    return step_flops(step)


@pytest.mark.parametrize("method", ["kadaptation", "lora"])
def test_train_step_counts_the_references_flops_but_for_the_programs_differences(
        clip_params, method):
    task, static, trainable, frozen, bn = _jax_task(clip_params, fused=False, method=method)
    images, labels = _data(B, seed=1)
    ones = jnp.ones((B,), jnp.float32)

    def loss_fn(tr):
        logits, _ = jt.model_forward(static, jcombine(tr, frozen), bn, jnp.asarray(images),
                                     task.preproc, train=True, rng=jax.random.PRNGKey(5),
                                     mask=ones)
        return jt._loss(static, logits, jnp.asarray(labels), ones)

    want = jax_step_flops(jax.grad(loss_fn), trainable)
    got = _port_step(method, trainable, frozen, bn, images, labels)
    v = TRAIN_SPEC.vision
    R, C = B * v.seq_len, v.width
    # the first block's input takes no gradient in the port: no dx through
    # its packed qkv projection nor through its q and v deltas
    first_block_dx = 2 * R * C * 3 * C
    first_block_dx += 2 * (2 * R * C * C if method == "kadaptation" else 2 * R * LORA_RANK * C)
    # KAdaptation's two shared rules, (P, P, 1) @ (P, 1, P), built in every
    # layer by the port and once by the reference's differentiated scan
    rules = 2 * (v.layers - 1) * 2 * PHM_DIM ** 3 if method == "kadaptation" else 0
    assert got == want - first_block_dx + rules


def test_operator_formulas_count_the_plain_products():
    rng = np.random.default_rng(0)
    Bt, N, H, hd = 2, 7, 3, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((Bt, N, H, hd)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    fwd = 4 * Bt * H * N * N * hd
    assert step_flops(attention_core, q, k, v) == fwd
    assert step_flops(lambda: attention_core(q, k, v).sum().backward()) == fwd + 2 * fwd
    jq, jk, jv = (jnp.asarray(t.detach().numpy()) for t in (q, k, v))
    assert jax_step_flops(_xla_attention_bnhd, jq, jk, jv) == fwd
    grad = jax.grad(lambda q, k, v: _xla_attention_bnhd(q, k, v).sum(), argnums=(0, 1, 2))
    assert jax_step_flops(grad, jq, jk, jv) == 3 * fwd  # forward plus the four products

    Cm, F, R = 64, 256, 10
    x = torch.randn(2, 5, Cm, requires_grad=True)
    w = [torch.ones(Cm), torch.zeros(Cm), torch.randn(Cm, F), torch.zeros(F),
         torch.randn(F, Cm), torch.zeros(Cm)]
    mlp = 4 * R * Cm * F
    assert step_flops(fused_mlp_residual, x, *w) == mlp
    assert step_flops(lambda: fused_mlp_residual(x, *w).sum().backward()) == 2 * mlp


def test_kronecker_sum_counts_the_references_einsum():
    a = np.random.default_rng(0).standard_normal((PHM_DIM, 4, 4)).astype(np.float32)
    b = np.random.default_rng(1).standard_normal((PHM_DIM, 8, 8)).astype(np.float32)
    got = step_flops(batched_kron_sum, torch.from_numpy(a), torch.from_numpy(b))
    assert got == jax_step_flops(jax_kron_sum, jnp.asarray(a), jnp.asarray(b)) == 2 * PHM_DIM * 4 ** 2 * 8 ** 2


def test_b32_train_step_lands_in_the_references_range():
    """A KAdaptation step at ViT-B/32, batch 32, counted on fake tensors (no
    compute): within the reference's own 18-26 GFLOP an image
    (tests/test_flops_ledger.py)."""
    spec = CLIPSpec.vit_b32()
    batch = 32
    with FakeTensorMode():
        clip = CLIP(spec).requires_grad_(False)
        peft = KAdaptation(spec.vision.layers, spec.vision.width)
        head = Head(spec.embed_dim, 100)
        static = TaskStatic(spec=spec, peft_cfg=PortPeftConfig(method="kadaptation"),
                            num_classes=100)
        images = torch.zeros(batch, spec.vision.grid ** 2, 32 * 32 * 3, dtype=torch.uint8)
        bn = {"mean": torch.zeros(spec.embed_dim), "var": torch.ones(spec.embed_dim)}
        pre = {"mean": torch.zeros(3), "std": torch.ones(3)}
        valid = torch.ones(batch)
        params = [*peft.parameters(), *head.parameters()]

        def step():
            logits, _ = model_forward(static, {"clip": clip, "peft": peft, "head": head}, bn,
                                      images, pre, train=True, mask=valid,
                                      generator=torch.Generator())
            torch.autograd.grad(_loss(static, logits, torch.zeros(batch, dtype=torch.long),
                                      valid), params, allow_unused=True)

        per_image = step_flops(step) / batch / 1e9
    assert 18.0 < per_image < 26.0, per_image


def test_chip_peaks():
    assert chip_peaks("NVIDIA H100 80GB HBM3") == (3350.0, 989.0, 67.0, 495.0)
    assert chip_peaks("NVIDIA H100 80GB HBM3").bf16_tflops == 989.0
    # TF32 on the tensor cores, the float32 bodies' three-product split
    assert chip_peaks("NVIDIA H100 80GB HBM3").tf32_tflops == 495.0
    # other cards, and the H100's other parts, are not in the table
    for kind in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        assert chip_peaks(kind) == (None, None, None, None)
    assert all(k == k.lower() for k in CHIP_SPECS)
