"""K1's float32 persistent body (``attention_fwd_f32_tma<W>`` in
``pevit_tpu_torch/ops/csrc/attention_fwd.cu``), held on the CPU where its
CUDA cannot run:

* its arithmetic, emulated in torch (:func:`emulate`): keys in chunks of
  ``F32_CHUNK``, S = Q Kᵀ a chunk at a time with every k-step of 8 along hd
  taken as three TF32 products summed exactly and added to the float32
  accumulator once, rounded (``tests/test_torch_tf32_split.py``'s
  ``tf32x3`` arithmetic); the online softmax in float32 (the running row
  max, the rescale of the row sum and of O by rounded products, e = exp(s
  - m), a lane's sum of key pairs, then the quad's); O += P V a chunk at a
  time in k-steps of 8 keys taken in V^T's permuted order (0, 2, 4, 6, 1,
  3, 5, 7); O / l.  It is held within the float32-class bound against
  float64 and against the reference's Pallas kernel in interpret mode at N
  = 1, 5, 50, 197 and 257 and hd 64 and 80, the one-product TF32 control
  exceeding that bound, and the permuted key order agrees with the natural
  one bit for bit (a narrow last chunk, where the keys below N fit half a
  chunk, ends the chunks where a full one does: no bit moves);
* the planes: Python mirrors of ``split_k`` and ``split_v`` (their address
  lines checked against the source) write a chunk's raw rows, laid out as
  TMA writes them in the 128-byte swizzle, into K's and V^T's planes, and
  the operands ``wgmma`` reads from them by the consumers' descriptors are
  K's and V's values where S and P V want them;
* the mirrors: the body's constants and layout (within the card's 232,448
  bytes a block at both widths) against the source;
* the walk: :func:`f32_walk`, the kernel's loops in Python (checked
  against the source), splits every (item, chunk) once a pair of query
  tiles and takes every (item, tile, chunk) once: both consumers on every
  chunk of a job of two tiles, or at one tile an item each consumer its
  items in turn on the plane stages of its parity, in order;
* the launch plan: float32 heads up to 80 wide run this body at every N,
  one block an SM at most, and ``check_grid`` counts its units.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.ops import attention as ja
from pevit_tpu_torch.ops import attention as ta
from pevit_tpu_torch.ops._build import CSRC, KernelInputError

from .test_torch_tf32_split import FP32_CLASS_FACTOR, FP32_HALF_ULP, bias, split, tf32_rna

SOURCE = " ".join((CSRC / "attention_fwd.cu").read_text().split())  # one space a gap
SMEM_BUDGET = 232448
K_STEP = 8
# V^T's planes: the key at each slot of an 8-key step (a lane's keys 2t and
# 2t + 1 at slots t and t + 4)
SLOT_KEYS = (0, 2, 4, 6, 1, 3, 5, 7)
NATURAL = tuple(range(8))


def _constant(name: str) -> int:
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    return int(value)


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------

def step_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One k-step (a (..., M, 8) . b (..., 8, N)) as the tensor cores take it
    from the split: lo.hi + hi.lo + hi.hi, exact, rounded once."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    d = lambda x, y: x.double() @ y.double()
    return (d(a_lo, b_hi) + d(a_hi, b_lo) + d(a_hi, b_hi)).float()


def step_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control: one TF32 product a k-step (what allow_tf32 gives)."""
    return (tf32_rna(a).double() @ tf32_rna(b).double()).float()


def kstep_product(a, b, step, order=NATURAL) -> torch.Tensor:
    """(..., M, K) . (..., K, N), K a multiple of 8: each k-step's columns
    taken in ``order``, its sum by ``step``, added to a float32
    accumulator from zero."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], K_STEP):
        idx = [k0 + j for j in order]
        acc = acc + step(a[..., idx], b[..., idx, :])
    return acc


# the keys a chunk of the mma.sync body, which runs float32 heads wider than
# F32_TMA_WIDTH with the same arithmetic a chunk
MMA_SYNC_CHUNK = 32


def chunk_of(hd: int) -> int:
    """The float32 keys a chunk at head width hd: the persistent body's up
    to F32_TMA_WIDTH, the mma.sync body's beyond."""
    return ta.F32_CHUNK if hd <= ta.F32_TMA_WIDTH else MMA_SYNC_CHUNK


def emulate(q, k, v, step=step_tf32x3, order=SLOT_KEYS, chunk=None,
            narrow: bool = True) -> torch.Tensor:
    """The body's arithmetic on (B, H, N, hd) float32 tensors; ``narrow``:
    a last chunk whose keys below N fit half a chunk takes half a chunk."""
    B, H, N, hd = q.shape
    chunk = chunk or chunk_of(hd)
    width = -(-hd // K_STEP) * K_STEP  # k-steps of zero columns add nothing
    chunks = -(-N // chunk)
    pad = lambda x, rows: torch.nn.functional.pad(x, (0, width - hd, 0, rows - N))
    q, k, v = pad(q, N), pad(k, chunks * chunk), pad(v, chunks * chunk)
    o = torch.zeros(B, H, N, width)
    m = torch.full((B, H, N), -torch.inf)
    lanes = torch.zeros(B, H, N, 4)  # a lane's part of the row sum, t = 0..3
    for ch in range(chunks):
        width_ = chunk // 2 if narrow and ch == chunks - 1 and N - ch * chunk <= chunk // 2 else chunk
        keys = slice(ch * chunk, ch * chunk + width_)
        s = kstep_product(q, k[:, :, keys].transpose(-1, -2), step)
        cols = torch.arange(ch * chunk, ch * chunk + width_)
        s = torch.where(cols < N, s, -torch.inf)
        new = torch.maximum(m, s.amax(-1))
        scale = torch.exp(m - new)
        m = new
        lanes = lanes * scale[..., None]
        o = o * scale[..., None]
        e = torch.exp(s - new[..., None])
        pairs = (e[..., 0::2] + e[..., 1::2]).reshape(B, H, N, width_ // K_STEP, 4)
        for j in range(width_ // K_STEP):  # keys 8j + 2t and + 1, in j's order
            lanes = lanes + pairs[..., j, :]
        o = o + kstep_product(e, v[:, :, keys], step, order)
    total = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])
    return (o / total[..., None])[..., :hd]


def qkv(n: int, hd: int, seed: int) -> tuple:
    """q, k, v (1, 2, n, hd) float32 with logits of std 0.5 (phase 3's)."""
    rng = np.random.default_rng(seed)
    s = (0.25 / hd) ** 0.25
    return tuple(torch.from_numpy((c * rng.standard_normal((1, 2, n, hd))).astype(np.float32))
                 for c in (s, s, 1.0))


def float64_attention(q, k, v) -> torch.Tensor:
    logits = q.double() @ k.double().transpose(-1, -2)
    return torch.softmax(logits, -1) @ v.double()


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("n", [1, 5, 50, 197, 257])
def test_emulation_is_float32_class(n, hd):
    """Against float64: max error within 4x the plain float32 version's
    (floored at 4 half-ulps of the largest output: at N = 1 the plain
    version is exact, p = 1, while the split leaves v's last bits) and the
    bias within the larger of 4x the plain version's and half an ulp; the
    one-product TF32 control exceeds the error bound.  Against the
    reference's Pallas kernel in interpret mode at the tolerance the plain
    version is held to (``test_torch_kernel_shapes``)."""
    q, k, v = qkv(n, hd, seed=n + hd)
    exact = float64_attention(q, k, v)
    err = lambda got: (got.double() - exact).abs().max().item()
    plain = ta.attention_ref(q, k, v)
    bound = FP32_CLASS_FACTOR * max(err(plain), FP32_HALF_ULP * exact.abs().max().item())
    bias_bound = max(FP32_CLASS_FACTOR * abs(bias(plain, exact)), FP32_HALF_ULP)
    got = emulate(q, k, v)
    assert err(got) <= bound, (err(got), bound)
    assert abs(bias(got, exact)) <= bias_bound, (bias(got, exact), bias_bound)
    control = emulate(q, k, v, step=step_tf32)
    assert err(control) > bound, (err(control), bound)
    want = ja._pallas_forward(*(jnp.asarray(x.numpy()) for x in (q, k, v)), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,hd", [(50, 64), (197, 64), (257, 80)])
def test_permuted_and_natural_key_orders_agree(n, hd):
    """V^T's planes take each 8-key step's keys in the order 0, 2, 4, 6, 1,
    3, 5, 7; each step's sum is exact before its one rounding, so the order
    changes no bit."""
    q, k, v = qkv(n, hd, seed=7 * n + hd)
    assert torch.equal(emulate(q, k, v, order=SLOT_KEYS), emulate(q, k, v, order=NATURAL))


@pytest.mark.parametrize("n", [5, 50, 80, 197, 257])
def test_a_narrow_last_chunk_moves_no_bit(n):
    """A last chunk whose keys below N fit half a chunk runs at half the
    width: the keys it leaves out are masked (p = 0) against zero rows of
    v, so the result is the full chunk's bit for bit."""
    q, k, v = qkv(n, 64, seed=11 * n)
    assert torch.equal(emulate(q, k, v, narrow=True), emulate(q, k, v, narrow=False))


def test_chunks_change_only_the_online_rescale():
    """At N within one chunk there is no rescale, so the chunk's size
    changes no bit; past it, both chunkings stay float32-class."""
    q, k, v = qkv(20, 64, seed=3)
    assert torch.equal(emulate(q, k, v, chunk=32), emulate(q, k, v, chunk=64))
    q, k, v = qkv(197, 64, seed=4)
    exact = float64_attention(q, k, v)
    plain = (ta.attention_ref(q, k, v).double() - exact).abs().max().item()
    for chunk in (32, 64):
        got = (emulate(q, k, v, chunk=chunk).double() - exact).abs().max().item()
        assert got <= FP32_CLASS_FACTOR * plain, (chunk, got, plain)


# ---------------------------------------------------------------------------
# the planes
# ---------------------------------------------------------------------------

def layout(width: int) -> dict:
    """``F32TmaBody<width>`` of the source, in Python."""
    kc, ps = ta.F32_CHUNK, ta.F32_PLANE_STAGES
    cb = -(-width // 32)
    block = kc * 128
    raw, k_plane, vt_block = 2 * cb * block, cb * block, width * 128
    vt_plane = kc // 32 * vt_block
    planes = ps * (2 * k_plane + 16 + 2 * vt_plane + 16)
    fit = (SMEM_BUDGET - 1024 - planes) // (raw + 16)
    rs = min(fit, 4)
    return {"kc": kc, "ps": ps, "cb": cb, "block": block, "raw": raw, "k_plane": k_plane,
            "vt_block": vt_block, "vt_plane": vt_plane, "rs": rs,
            "smem": 1024 + rs * (raw + 16) + planes}


def swizzled(row: int, chunk: int) -> int:
    """The byte of 16-byte chunk ``chunk`` of 128-byte row ``row`` in the
    128-byte swizzle (TMA's and wgmma's, rows from a 1024-byte boundary)."""
    return row * 128 + ((chunk ^ (row % 8)) << 4)


def raw_rows(x: np.ndarray, width: int) -> np.ndarray:
    """A chunk's rows (keys x columns, float32) as TMA writes them: column
    blocks of 32 floats, a key's 128 bytes a row, swizzled; columns past
    the tensor's zero."""
    lay = layout(width)
    out = np.zeros(lay["raw"] // 2 // 4, np.float32)
    for r in range(x.shape[0]):
        for col in range(lay["cb"] * 32):
            at = col // 32 * lay["block"] + swizzled(r, col % 32 // 4) + col % 4 * 4
            out[at // 4] = x[r, col] if col < x.shape[1] else 0.0
    return out


def split_k_mirror(raw: np.ndarray, width: int) -> tuple:
    """``split_k``'s addresses: each 16-byte chunk's values split where they
    lie."""
    lay, q = layout(width), width // 4
    hi, lo = np.zeros_like(raw), np.zeros_like(raw)
    for i in range(lay["kc"] * q):
        r, c = divmod(i, q)
        at = (c // 8 * lay["block"] + r * 128 + (((c % 8) ^ (r % 8)) << 4)) // 4
        h, l_ = split(torch.from_numpy(raw[at:at + 4].copy()))
        hi[at:at + 4], lo[at:at + 4] = h.numpy(), l_.numpy()
    return hi, lo


def split_v_mirror(raw: np.ndarray, width: int) -> tuple:
    """``split_v``'s addresses: V's value (key, column d) into V^T's row d,
    at its key's slot of its 8-key step."""
    lay = layout(width)
    hi = np.zeros(lay["vt_plane"] // 4, np.float32)
    lo = np.zeros_like(hi)
    for i in range(width * (lay["kc"] // 8)):
        d, s = i % width, i // width
        col = d // 32 * lay["block"] + d % 4 * 4
        dc = d % 32 // 4
        row = s // 4 * lay["vt_block"] + d * 128
        for odd in range(2):
            keys = [8 * s + 2 * u + odd for u in range(4)]
            x = np.array([raw[(col + key * 128 + ((dc ^ (key % 8)) << 4)) // 4] for key in keys],
                         np.float32)
            h, l_ = split(torch.from_numpy(x))
            at = (row + (((s % 4 * 2 + odd) ^ (d % 8)) << 4)) // 4
            hi[at:at + 4], lo[at:at + 4] = h.numpy(), l_.numpy()
    return hi, lo


def wgmma_b(plane: np.ndarray, start: int, rows: int) -> np.ndarray:
    """The (8 x rows) B operand a K-major, 128-byte-swizzled descriptor at
    byte ``start`` (a k-step's 32 bytes into a block) names: B[k][n] is row
    n's TF32 value k of the k-step."""
    base, off = start // 1024 * 1024, start % 1024  # the swizzle's 1024-byte pattern
    out = np.zeros((8, rows), np.float32)
    for n in range(rows):
        for kk in range(8):
            chunk = off // 16 + kk // 4
            out[kk, n] = plane[(base + swizzled(n, chunk) + kk % 4 * 4) // 4]
    return out


def test_split_sources_are_mirrored():
    """The address lines the mirrors copy stand in the source."""
    for line in ("at[u] = c / 8 * L::BLOCK + r * 128 + (((c % 8) ^ (r % 8)) << 4);",
                 "const unsigned char* col = raw + d / 32 * L::BLOCK + d % 4 * 4;",
                 "unsigned char* row = v_hi + s / 4 * L::VT_BLOCK + d * 128;",
                 "const int key = 8 * s + 2 * u + odd;",
                 "((dc ^ (2 * u + odd)) << 4));",
                 "const int at = ((s % 4 * 2 + odd) ^ (d % 8)) << 4;",
                 "const uint32_t kb = kp + kk / 4 * L::BLOCK + kk % 4 * 32;",
                 "const uint32_t vb = vp + j / 4 * L::VT_BLOCK + j % 4 * 32;",
                 "const float p[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};"):
        assert line in SOURCE, line


@pytest.mark.parametrize("width", [64, 80])
def test_planes_are_the_wgmma_operands(width):
    """A chunk's raw K and V rows through the mirrors of ``split_k`` and
    ``split_v``, then read back as the consumers' descriptors name them:
    S's k-step kk is K's columns 8kk..8kk+7 of every key, split; P V's
    k-step j is V's rows at keys 8j + (0, 2, 4, 6, 1, 3, 5, 7), split, so
    that k-index t holds key 2t and t + 4 key 2t + 1, a lane's S
    accumulators; the hi and lo planes hold what ``split`` gives."""
    lay = layout(width)
    kc = lay["kc"]
    rng = np.random.default_rng(width)
    hd = width - 4  # columns past hd arrive as zeros
    kx, vx = (rng.standard_normal((kc, hd)).astype(np.float32) for _ in range(2))
    k_hi, k_lo = split_k_mirror(raw_rows(kx, width), width)
    v_hi, v_lo = split_v_mirror(raw_rows(vx, width), width)
    kpad = np.pad(kx, ((0, 0), (0, width - hd)))
    vpad = np.pad(vx, ((0, 0), (0, width - hd)))
    for kk in range(width // 8):
        start = kk // 4 * lay["block"] + kk % 4 * 32
        want_hi, want_lo = split(torch.from_numpy(kpad[:, 8 * kk:8 * kk + 8].T.copy()))
        np.testing.assert_array_equal(wgmma_b(k_hi, start, kc), want_hi.numpy())
        np.testing.assert_array_equal(wgmma_b(k_lo, start, kc), want_lo.numpy())
    for j in range(kc // 8):
        start = j // 4 * lay["vt_block"] + j % 4 * 32
        rows = vpad[[8 * j + key for key in SLOT_KEYS]]
        want_hi, want_lo = split(torch.from_numpy(rows))
        np.testing.assert_array_equal(wgmma_b(v_hi, start, width), want_hi.numpy())
        np.testing.assert_array_equal(wgmma_b(v_lo, start, width), want_lo.numpy())
    # a lane's S accumulators (keys 2t, 2t + 1 of a step) at A's k-indices
    # t and t + 4
    assert [SLOT_KEYS[t] for t in range(4)] == [2 * t for t in range(4)]
    assert [SLOT_KEYS[t + 4] for t in range(4)] == [2 * t + 1 for t in range(4)]


# ---------------------------------------------------------------------------
# the mirrors
# ---------------------------------------------------------------------------

def test_mirrors_match_the_source():
    for name in ("F32_CHUNK", "F32_PLANE_STAGES", "F32_TMA_WIDTH"):
        assert _constant(name) == getattr(ta, name), name
    assert ta.F32_TMA_WIDTH == 80
    assert ta.F32_CHUNK % 32 == 0 and ta.F32_PLANE_STAGES % 2 == 0
    assert "static_assert(RS >= 1 && PS % 2 == 0 && SMEM <= SMEM_BUDGET" in SOURCE
    (cc,) = re.findall(r"constexpr int KC = (\d+); // keys per chunk", SOURCE)
    assert int(cc) == MMA_SYNC_CHUNK  # the mma.sync body's, which hd > 80 runs
    for width in (64, 80):
        lay = layout(width)
        assert 1 <= lay["rs"] <= 4 and lay["smem"] <= SMEM_BUDGET, (width, lay)
        for size in ("block", "k_plane", "vt_block"):  # tiles on the swizzle's 1024 bytes
            assert lay[size] % 1024 == 0, (width, size)
    # the launcher's routes: widths 64 and 80 to this body, wider heads to
    # the mma.sync body
    for w in (64, 80):
        assert f"case {w}: return launch_f32_tma<{w}>(a);" in SOURCE
    for w in (96, 128):
        assert f"case {w}: return launch_f32<{w}>(a);" in SOURCE
    assert "default: return launch_f32<256>(a);" in SOURCE


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

def f32_walk(items: int, q_tiles: int, grid: int, chunks: int) -> dict:
    """The kernel's loops in Python.  With more than one query tile an item,
    block b walks jobs b, b + grid, ... (job w: item w // JT, its tiles 2 (w
    % JT) and + 1, JT = ceil(q_tiles / 2)), and both consumers take every
    entry of a job (its chunks); with one, it walks units (an item each),
    unit i to consumer i % 2, and unit i's chunk ch is entry 2 (C (i / 2) +
    ch) + i % 2, skipped where the unit is missing.  Returns, by block, the
    producer's present entries (entry, item, chunk) in order and each
    consumer's (entry, item, tile, chunk) in order."""
    paired, jt = q_tiles > 1, -(-q_tiles // 2)
    work = items * jt
    out = {}
    for b in range(min(grid, work)):
        mine = (work - b + grid - 1) // grid
        entries = chunks * mine if paired else 2 * chunks * ((mine + 1) // 2)
        produced = []
        for e in range(entries):
            if paired:
                produced.append((e, (b + e // chunks * grid) // jt, e % chunks))
                continue
            i = e // (2 * chunks) * 2 + e % 2
            if i < mine:
                produced.append((e, b + i * grid, e // 2 % chunks))
        consumers = {}
        for c in (0, 1):
            taken = []
            for j in (range(mine) if paired else range(c, mine, 2)):
                w = b + j * grid
                item, tile = (w // jt, 2 * (w % jt) + c) if paired else (w, 0)
                for ch in range(chunks):
                    e = j * chunks + ch if paired else 2 * (chunks * (j // 2) + ch) + c
                    taken.append((e, item, tile, ch))
            consumers[c] = taken
        out[b] = (produced, consumers)
    return out


def test_the_walk_mirrors_the_kernels_loops():
    for line in ("const int mine = (a.work - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;",
                 "const int entries = paired ? C * mine : 2 * C * ((mine + 1) / 2);",
                 "item = ((int)blockIdx.x + e / C * (int)gridDim.x) / JT; ch = e % C;",
                 "const int i = e / (2 * C) * 2 + e % 2; // the entry's unit",
                 "item = (int)blockIdx.x + i * (int)gridDim.x; ch = e / 2 % C; return i < mine;",
                 "const bool paired = a.q_tiles > 1;",
                 "for (int j = paired ? 0 : c; j < mine; j += paired ? 1 : 2) {",
                 "const int item = paired ? w / JT : w, qt = paired ? 2 * (w % JT) + c : 0;",
                 "return paired ? j * C + ch : 2 * (C * (j / 2) + ch) + c;",
                 "const int e = entry(ch), ps = e % PS, par = e / PS & 1;",
                 "mbar_init(k_empty + 8 * s, paired ? 2 * WARPS : WARPS);",
                 "const int s = issued % RS, use = issued / RS;",
                 "const int s = n % RS, rpar = n / RS & 1, ps = e % PS, ppar = e / PS & 1;"):
        assert line in SOURCE, line


@pytest.mark.parametrize("q_tiles", [1, 2, 3, 4, 5])
def test_the_walk_takes_every_chunk_once(q_tiles):
    """Every (item, chunk) produced once a pair of query tiles (once a
    tile unpaired) and every (item, tile, chunk) taken once; paired, both
    consumers take every entry, each its own tile of the job; unpaired,
    each consumer its own units' entries, on the plane stages of its
    parity, each stage's uses one after another."""
    ps, jt = ta.F32_PLANE_STAGES, -(-q_tiles // 2)
    chunks = 3
    for items in (1, 2, 3, 12, 131, 132, 133, 265, 768):
        for grid in (1, 2, 7, 132):
            made, taken = [], []
            for b, (produced, consumers) in f32_walk(items, q_tiles, grid, chunks).items():
                made += [(item, ch) for _, item, ch in produced]
                entries = [e for e, _, _ in produced]
                assert entries == sorted(entries)
                for c, mine in consumers.items():
                    es = [e for e, _, _, _ in mine]
                    assert es == sorted(es) and set(es) <= set(entries)
                    if q_tiles == 1:
                        assert all(e % 2 == c and e % ps % 2 == c for e in es)
                        for stage in range(c, ps, 2):
                            uses = [e // ps for e in es if e % ps == stage]
                            assert uses == list(range(len(uses)))
                    else:
                        assert es == entries  # both consumers on every entry
                    produced_at = {e: (item, ch) for e, item, ch in produced}
                    for e, item, tile, ch in mine:
                        assert produced_at[e] == (item, ch)
                        if tile < q_tiles:
                            taken.append((item, tile, ch))
            assert sorted(made) == sorted((i, ch) for i in range(items) for _ in range(jt)
                                          for ch in range(chunks))
            assert sorted(taken) == sorted((i, t, ch) for i in range(items)
                                           for t in range(q_tiles) for ch in range(chunks))


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def test_every_fp32_width_lands_on_its_body():
    """float32 heads up to 80 (hd padded to whole 16-byte chunks) run this
    body at every N with one block an SM at most, walking jobs of two query
    tiles at hd <= 64 past one tile, else (batch, head, query tile) units;
    wider heads the mma.sync body."""
    for hd in range(1, ta.MAX_HEAD_DIM + 1):
        for n in (1, 50, 64, 65, 197, 257, 577, 1025):
            plan = ta.launch_plan(3, n, 5, hd, torch.float32)
            tiles = -(-n // ta.QUERY_TILE)
            work = 15 * -(-tiles // 2)
            if plan.hd <= ta.F32_TMA_WIDTH:
                assert (plan.body, plan.blocks, plan.keys) == ("f32_tma", min(ta.H100_SMS, work), 0)
                assert plan.width in (64, 80)
            else:
                assert plan.body == "f32" and plan.width in (96, 128, 256)


@pytest.mark.parametrize("n,hd", [(50, 64), (197, 64), (257, 80)])
def test_check_grid_counts_the_units(n, hd):
    """The largest batch of 12 heads the body takes, and one more image."""
    per_image = 12 * -(-n // ta.QUERY_TILE)
    B = ta.MAX_BLOCKS // per_image
    ta.check_grid(B, 12, n, torch.float32, hd)
    assert ta.launch_plan(B, n, 12, hd, torch.float32).blocks == ta.H100_SMS
    with pytest.raises(KernelInputError, match="blocks"):
        ta.check_grid(B + 1, 12, n, torch.float32, hd)
