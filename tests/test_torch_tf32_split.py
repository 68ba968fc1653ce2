"""The numerical design of the kernels' float32 bodies, on the CPU.

K1's, K2's and K3's float32 bodies (``pevit_tpu_torch/ops/csrc/tf32x3.cuh``)
run their products on the tensor cores as three TF32 products: x splits into
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
accumulation does.  K3's whole backward chain (its three products, the
QuickGELU derivative and the LayerNorm backward) is held the same way at
toy width.  The card runs the same checks on the kernels themselves
(``chip_smoke.py`` phases 3 and 3b); the last tests check that the texts
the card-side tools edit in copies of the sources still stand there.
"""

import importlib.util
from pathlib import Path

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


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, truncate: bool = False,
                  planes: tuple = None) -> torch.Tensor:
    """(M, K) float32 . (K, N) float32 as the kernels compute it: per k-step
    of 8 the three products of the split, exact, rounded once to float32,
    then added to the float32 accumulator (rounding toward zero where
    ``truncate``).  ``planes``: b's hi and lo parts as given, split ahead
    (the fused MLP's weights), in place of ``split(b)``."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b) if planes is None else planes
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


# ---------------------------------------------------------------------------
# K3's float32 body: the whole backward chain, every product through the split
# ---------------------------------------------------------------------------

K3_R, K3_C, K3_F = 64, 256, 1024


def k3_operands(seed: int) -> tuple:
    """dy, x and the frozen weights of the fused MLP's backward, drawn as
    ``chip_smoke.check_fused_mlp_bwd`` draws them, at toy width."""
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    c, f = K3_C, K3_F
    dy, x = r(K3_R, c), r(K3_R, c)
    ln_s, ln_b = 1 + 0.1 * r(c), 0.1 * r(c)
    wfc, bfc = r(c, f) * c ** -0.5, 0.1 * r(f)
    wproj = r(f, c) * f ** -0.5
    return dy, x, ln_s, ln_b, wfc, bfc, wproj


def k3_chain(dy, x, ln_s, ln_b, wfc, bfc, wproj, matmul, eps: float = 1e-5):
    """dx of the fused residual MLP as K3's float32 body computes it, with
    its three products (u . Wfc, dy . Wproj^T, dh . Wfc^T) taken by
    ``matmul`` and everything else in float32 as ``fused_mlp_bwd_ref``: the
    LayerNorm statistics, the QuickGELU derivative and the LayerNorm
    backward stay off the tensor cores."""
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x - mean).square().mean(-1, keepdim=True) + eps)
    xhat = (x - mean) * rstd
    h = matmul(xhat * ln_s + ln_b, wfc) + bfc
    sig = torch.sigmoid(1.702 * h)
    dh = matmul(dy, wproj.T.contiguous()) * (sig * (1.0 + 1.702 * h * (1.0 - sig)))
    dxhat = matmul(dh, wfc.T.contiguous()) * ln_s
    mdx, mdxx = dxhat.mean(-1, keepdim=True), (dxhat * xhat).mean(-1, keepdim=True)
    return (dxhat - mdx - xhat * mdxx) * rstd + dy


def test_k3_chain_is_the_plain_backward():
    """With plain float32 products the chain is the port's plain backward,
    so the tests below hold the kernel's design, not another function."""
    from pevit_tpu_torch.ops.fused_mlp import fused_mlp_bwd_ref

    args = k3_operands(0)
    torch.testing.assert_close(k3_chain(*args, torch.matmul), fused_mlp_bwd_ref(*args),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_k3_chain_stays_float32_class(seed):
    """K3's chain with every product as three TF32 products a k-step, each
    k-step added once, rounded: within 4x the plain float32 backward's max
    error and bias against float64, as ``chip_smoke.fp32_class`` holds the
    kernel on the card; one TF32 product a k-step (the TF32 control)
    exceeds the error bound, and the same chain with each k-step's add
    truncated toward zero exceeds the bias bound."""
    from pevit_tpu_torch.ops.fused_mlp import fused_mlp_bwd_ref

    args = k3_operands(seed)
    exact = k3_chain(*(t.double() for t in args), torch.matmul)
    err = lambda got: (got.double() - exact).abs().max().item()
    plain = fused_mlp_bwd_ref(*args)
    bound = FP32_CLASS_FACTOR * err(plain)
    bias_bound = max(FP32_CLASS_FACTOR * abs(bias(plain, exact)), FP32_HALF_ULP)
    got = k3_chain(*args, tf32x3_matmul)
    assert 0.0 < err(got) <= bound, (seed, err(got), bound)
    assert abs(bias(got, exact)) <= bias_bound, (seed, bias(got, exact), bias_bound)
    control = k3_chain(*args, tf32_matmul)
    assert err(control) > bound, (seed, err(control), bound)
    truncated = k3_chain(*args, lambda a, b: tf32x3_matmul(a, b, truncate=True))
    assert bias(truncated, exact) < -bias_bound, (seed, bias(truncated, exact), bias_bound)


REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "pevit_tpu_torch" / "ops" / "csrc"


def load_tool(name: str):
    """A script of ``tools/`` (not a package) as a module."""
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("variant", ["bigfirst", "rz", "chain", "k1_pairs", "k3_pairs"])
def test_every_fp32_mutant_still_edits_the_sources(variant):
    """``tools/fp32_check_mutants.py`` builds each broken float32 body by
    replacing text in a copy of the kernel sources; each text it replaces
    must stand exactly once in the sources as they are, or the variant
    would not be the body it names."""
    tool = load_tool("fp32_check_mutants")
    assert sorted(tool.VARIANTS) == sorted(["bigfirst", "rz", "chain", "k1_pairs", "k3_pairs"])
    kernels, edits = tool.VARIANTS[variant]
    assert edits and set(kernels) <= set(tool.ALL)
    for name, old, new in edits:
        assert (CSRC / name).read_text().count(old) == 1, (variant, name, old)
        assert old != new


@pytest.mark.parametrize("variant", ["du_wide", "dh_wide", "no_unroll"])
def test_every_k3_variant_still_edits_the_source(variant):
    """``tools/k3_fp32_variants.py`` times K3's float32 body against
    variants it makes by replacing text in a copy of the sources; each text
    must stand exactly once in the source as it is."""
    tool = load_tool("k3_fp32_variants")
    assert sorted(tool.VARIANTS) == sorted(["shipped", "du_wide", "dh_wide", "no_unroll"])
    for name, old, new in tool.VARIANTS[variant]:
        assert (CSRC / name).read_text().count(old) == 1, (variant, name, old)
        assert old != new


def test_every_k1_stamp_still_edits_the_source():
    """``tools/k1_f32_stamps.py`` splits K1's float32 body into phases by
    stamps it adds after or before texts of a copy of the source; each
    text must stand exactly once in the source as it is."""
    tool = load_tool("k1_f32_stamps")
    source = (CSRC / "attention_fwd.cu").read_text()
    assert len(tool.EDITS) == 14
    for anchor, where, _ in tool.EDITS:
        assert source.count(anchor) == 1, anchor
        assert where in ("after", "before")
    assert tool.stamped(source, {}).count("STAMP(") == 12
