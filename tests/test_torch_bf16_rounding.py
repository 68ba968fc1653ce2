"""The bfloat16 rounding points that the kernels' bf16 bodies keep, held on
the CPU: the port's plain versions in bfloat16 against the reference's
Pallas kernels in interpret mode, on the same bf16 inputs.

* attention (K1): logits, softmax and its normalisation in float32, p
  rounded to bf16 before the product with v, the output rounded once (also
  at N = 50, 197 and 257 with 12 heads, the persistent body's lengths);
* fused MLP forward (K2): u and g rounded to bf16, h in float32 with bfc
  widened, m rounded to bf16 and added to x in bf16;
* fused MLP backward (K3): u and dh rounded to bf16, the rest in float32,
  the LayerNorm backward rounded and added to dy in bf16.

Tolerance: one bf16 ulp of the output's largest magnitude (atol), and at
most 1% of the elements may differ at all (the two stacks sum in different
orders, so a float32 value on a rounding boundary may round the other way).
The control cases show that the check tells rounding points apart: the
same function in float32 on the same inputs, rounded only at the end,
differs in far more elements.

The registry: ``pevit_tpu_torch.ops.KERNELS`` holds exactly one kernel for
each function of the reference that reaches ``pl.pallas_call``, and each
kernel's ``replaces`` names that function's ``def`` line.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.ops import attention as ja
from pevit_tpu.ops.fused_mlp import fused_mlp_residual as jax_fused
from pevit_tpu_torch.ops import KERNELS
from pevit_tpu_torch.ops import attention as ta
from pevit_tpu_torch.ops import fused_mlp as tf

from .test_torch_fused_mlp import NAMES, C, _params

REPO = Path(__file__).resolve().parents[1]
MAX_DIFFERING = 0.01


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _numpy(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulp(a: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of ``a`` (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def _assert_same_rounding(got: torch.Tensor, want: np.ndarray):
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_ulp(want))
    assert (got != want).mean() <= MAX_DIFFERING


def _qkv(n, seed, batch=2, heads=3):
    rng = np.random.default_rng(seed)
    return tuple(_bf16(s * rng.standard_normal((batch, heads, n, 64))) for s in (0.5, 0.5, 1.0))


@pytest.mark.parametrize("n", [5, 50, 197, 258, 577, 1025])
def test_attention_ref_bf16_matches_pallas_kernel(n):
    q, k, v = _qkv(n, seed=n)
    want = _numpy(ja._fused(_jax(q), _jax(k), _jax(v), True))  # interpret mode
    got = ta.attention_ref(q, k, v)
    assert got.dtype == torch.bfloat16
    _assert_same_rounding(got, want)


@pytest.mark.parametrize("n", [50, 197, 257])
def test_attention_ref_bf16_matches_pallas_kernel_at_12_heads(n):
    """The lengths K1's persistent body takes on the paths (ViT-B/32,
    ViT-B/16, ViT-L/14 at 224 px) at ViT-B's 12 heads of 64."""
    q, k, v = _qkv(n, seed=1000 + n, batch=1, heads=12)
    want = _numpy(ja._fused(_jax(q), _jax(k), _jax(v), True))  # interpret mode
    got = ta.attention_ref(q, k, v)
    assert got.dtype == torch.bfloat16
    _assert_same_rounding(got, want)


@pytest.mark.parametrize("n", [5, 50, 197, 577])
def test_attention_unrounded_p_is_told_apart(n):
    """Control: p left in float32 (no rounding before PV) changes the
    output in many elements, so the check above pins the rounding point."""
    q, k, v = _qkv(n, seed=n)
    want = _numpy(ja._fused(_jax(q), _jax(k), _jax(v), True))
    other = ta.attention_ref(q.float(), k.float(), v.float()).bfloat16().float().numpy()
    assert (other != want).mean() > 10 * MAX_DIFFERING


def _mlp_inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    p = _params(seed)
    w = [torch.from_numpy(p[k]) if k.startswith("ln") else _bf16(p[k]) for k in NAMES]
    x, dy = (_bf16(rng.standard_normal((b, n, C))) for _ in range(2))
    return x, dy, w


def _jax_dx(x, dy, w):
    jw = [_jax(t) for t in w]
    _, vjp = jax.vjp(lambda xx: jax_fused(xx, *jw, True), _jax(x))  # interpret mode
    (dx,) = vjp(_jax(dy))
    return _numpy(dx)


def _jax_y(x, w):
    return _numpy(jax_fused(_jax(x), *(_jax(t) for t in w), True))  # interpret mode


@pytest.mark.parametrize("b,n", [(5, 7), (2, 200), (3, 12)])
def test_fused_mlp_ref_bf16_matches_pallas_forward(b, n):
    """35, 400 and 36 rows: none fills the reference's 256-row tiles."""
    x, _, w = _mlp_inputs(b, n, seed=b * n)
    got = tf.fused_mlp_residual_ref(x, *w)
    assert got.dtype == torch.bfloat16
    _assert_same_rounding(got, _jax_y(x, w))


@pytest.mark.parametrize("b,n", [(5, 7), (2, 200), (3, 12)])
def test_fused_mlp_fwd_unrounded_is_told_apart(b, n):
    """Control: u, g and m left in float32, with x + m rounded once at the
    end, change y in many elements."""
    x, _, w = _mlp_inputs(b, n, seed=b * n)
    other = tf.fused_mlp_residual_ref(x.float(), *(t.float() for t in w))
    other = other.bfloat16().float().numpy()
    assert (other != _jax_y(x, w)).mean() > 10 * MAX_DIFFERING


@pytest.mark.parametrize("b,n", [(5, 7), (2, 200), (3, 12)])
def test_fused_mlp_bwd_ref_bf16_matches_pallas_backward(b, n):
    """35, 400 and 36 rows: none fills the reference's 256-row tiles."""
    x, dy, w = _mlp_inputs(b, n, seed=b * n)
    got = tf.fused_mlp_bwd_ref(dy, x, *w[:-1])
    assert got.dtype == torch.bfloat16
    _assert_same_rounding(got, _jax_dx(x, dy, w))


@pytest.mark.parametrize("b,n", [(5, 7), (2, 200), (3, 12)])
def test_fused_mlp_bwd_unrounded_is_told_apart(b, n):
    """Control: u, dh and the LayerNorm backward left in float32 change dx
    in many elements."""
    x, dy, w = _mlp_inputs(b, n, seed=b * n)
    other = tf.fused_mlp_bwd_ref(dy.float(), x.float(), *(t.float() for t in w[:-1]))
    other = other.bfloat16().float().numpy()
    assert (other != _jax_dx(x, dy, w)).mean() > 10 * MAX_DIFFERING


def _pallas_functions() -> set:
    """``file:line`` of every ``def`` in the reference package whose body
    reaches ``pl.pallas_call``."""
    found = set()
    for path in sorted((REPO / "pevit_tpu").rglob("*.py")):
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if "pl.pallas_call(" not in line:
                continue
            indent = len(line) - len(line.lstrip())
            j = next(j for j in range(i, -1, -1) if re.match(rf"^\s{{0,{indent - 1}}}def ", lines[j]))
            found.add(f"{path.relative_to(REPO)}:{j + 1}")
    return found


def test_registry_holds_the_three_kernels():
    assert [k.name for k in KERNELS] == ["attention_fwd", "fused_mlp_fwd", "fused_mlp_bwd"]
    assert {k.replaces for k in KERNELS} == {"pevit_tpu/ops/attention.py:40",
                                             "pevit_tpu/ops/fused_mlp.py:63",
                                             "pevit_tpu/ops/fused_mlp.py:122"}


def test_registry_covers_every_pallas_call():
    assert {k.replaces for k in KERNELS} == _pallas_functions()


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
def test_replaces_names_the_pallas_function(kernel):
    path, line = kernel.replaces.split(":")
    text = (REPO / path).read_text().splitlines()[int(line) - 1]
    assert re.match(r"def _pallas_\w+\(", text), text
    assert kernel.source.is_file() and kernel.source.parent.name == "csrc"
