"""The numerical design of the kernels' float32 bodies, on the CPU.

K1's and K2's float32 bodies (``pevit_tpu_torch/ops/csrc/tf32x3.cuh``) run
their products on the tensor cores as three TF32 products: x splits into
hi = cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(x - hi), and a . b is
taken as a_lo . b_hi + a_hi . b_lo + a_hi . b_hi, summed over each k-step of
8 (TF32 products are exact) and added to a float32 accumulator once per
k-step.  Here that arithmetic is emulated in torch on the float32 bit
pattern and held against float64 at the kernels' contraction lengths: 64
(q . k^T over the head width), 197 and 257 (P . V over the keys), 768 and
3072 (K2's two GEMMs at ViT-B width).  It must stay within
``FP32_CLASS_FACTOR`` x the error of a plain float32 product, and one TF32
product (what ``allow_tf32`` gives) must not: the control shows that the
bound tells float32 from TF32.  Its bias, the mean error signed toward the
float64 result, must stay within the larger of ``FP32_CLASS_FACTOR`` x the
plain product's and half a float32 ulp, and the same sum with each k-step's
add truncated toward zero must not: truncation is what a tensor core's
accumulation does.  The card runs the same checks on the kernels
themselves (``chip_smoke.py`` phase 3).
"""

import numpy as np
import pytest
import torch

FP32_CLASS_FACTOR = 4.0  # chip_smoke.FP32_CLASS_FACTOR
FP32_HALF_ULP = 2.0 ** -24  # chip_smoke.FP32_HALF_ULP
K_STEP = 8


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, rounding to nearest with
    ties away from zero (add half of the 13 dropped bits to the magnitude's
    bit pattern, then clear them).  Finite float32 in, float32 out."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounding toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, truncate: bool = False) -> torch.Tensor:
    """(M, K) float32 . (K, N) float32 as the kernels compute it: per k-step
    of 8 the three products of the split, exact, rounded once to float32,
    then added to the float32 accumulator (rounding toward zero where
    ``truncate``)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], K_STEP):
        s = slice(k0, k0 + K_STEP)
        d = lambda x, y: x[:, s].double() @ y[s].double()
        step = (d(a_lo, b_hi) + d(a_hi, b_lo) + d(a_hi, b_hi)).float()
        acc = toward_zero(acc.double() + step.double()) if truncate else acc + step
    return acc


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control: one TF32 product a_hi . b_hi a k-step, as allow_tf32
    gives (inputs rounded to TF32, float32 accumulation)."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], K_STEP):
        s = slice(k0, k0 + K_STEP)
        acc = acc + (a_hi[:, s].double() @ b_hi[s].double()).float()
    return acc


def operands(k: int, seed: int) -> tuple:
    """The kernels' operands at contraction length k: K2's LayerNormed rows
    against Wfc / g against Wproj (k = 768, 3072), q against k (k = 64, q
    carrying the 1/8 scale), softmax probabilities against v over k keys
    (k = 197, 257)."""
    rng = np.random.default_rng(seed)
    m, n = 64, 64
    if k in (197, 257):
        logits = rng.standard_normal((m, k)) * 2.0
        a = np.exp(logits - logits.max(1, keepdims=True))
        a /= a.sum(1, keepdims=True)
        b = rng.standard_normal((k, n))
    else:
        a = rng.standard_normal((m, k)) * (0.125 if k == 64 else 1.0)
        b = rng.standard_normal((k, n)) * k ** -0.5
    return torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32))


def test_rna_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -11  # halfway between 1 and the next TF32 value, 1 + 2^-10
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, 0.0, -2.5],
                     dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 1.0 + 2.0 ** -10, 0.0, -2.5]
    assert tf32_rna(x).tolist() == want
    # a tie rounds away from zero, not to even (1 has the even mantissa)
    assert tf32_rna(x[:1]).item() != 1.0


def test_split_reconstructs_x_to_float32_rounding():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    x = x * torch.logspace(-20, 20, 4096, base=2.0)
    hi, lo = split(x)
    for part in (hi, lo):  # TF32 bit patterns: the 13 low bits clear
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # x - hi is exact in float32, so lo loses only its own rounding to TF32
    assert torch.equal((x - hi).double(), x.double() - hi.double())
    assert ((hi.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs()).all()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()


@pytest.mark.parametrize("k", [64, 197, 257, 768, 3072])
def test_three_products_stay_float32_class(k):
    """At each kernel's contraction length: 3xTF32 within 4x the plain
    float32 product's max abs error against float64 (two seeds); one TF32
    product exceeds that bound."""
    for seed in (0, 1):
        a, b = operands(k, seed)
        exact = a.double() @ b.double()
        err = lambda got: (got.double() - exact).abs().max().item()
        plain = err(a @ b)
        bound = FP32_CLASS_FACTOR * plain
        assert 0.0 < plain
        got = err(tf32x3_matmul(a, b))
        assert got <= bound, (k, seed, got, plain)
        assert err(tf32_matmul(a, b)) > bound, (k, seed, err(tf32_matmul(a, b)), plain)


def bias(got: torch.Tensor, exact: torch.Tensor) -> float:
    """chip_smoke.fp32_class's bias: sum((got - exact) * exact) / sum(exact^2)."""
    return ((got.double() - exact) * exact).sum().item() / exact.square().sum().item()


@pytest.mark.parametrize("k", [64, 197, 257, 768, 3072])
def test_bias_bound_refuses_a_truncating_add(k):
    """At each kernel's contraction length: 3xTF32's bias within the larger
    of 4x the plain float32 product's and half a float32 ulp (two seeds);
    the same sum with each k-step's add truncated toward zero exceeds it."""
    for seed in (0, 1):
        a, b = operands(k, seed)
        exact = a.double() @ b.double()
        bound = max(FP32_CLASS_FACTOR * abs(bias(a @ b, exact)), FP32_HALF_ULP)
        got = bias(tf32x3_matmul(a, b), exact)
        assert abs(got) <= bound, (k, seed, got, bound)
        truncated = bias(tf32x3_matmul(a, b, truncate=True), exact)
        assert truncated < -bound, (k, seed, truncated, bound)
