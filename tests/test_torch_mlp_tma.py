"""The fused MLP's GEMM core (``gemm_persistent`` in
``pevit_tpu_torch/ops/csrc/wgmma_gemm.cuh``, under K2's ``fc`` and ``proj``
and K3's ``dh`` pair and ``du``, bf16 and float32), held on the CPU where
its CUDA cannot run:

* the mirrors: ``ops/fused_mlp.py``'s constants of the core (tile rows, K
  a stage, consumers, setmaxnreg's register counts, the stages' cap) and
  of each product (tile width, products a tile, B MN- or K-major) are the
  sources' own, read from the ``.cuh`` and ``.cu`` text, as is the
  shared-memory budget (``tma.cuh``); the registers of a block fit an SM,
  a consumer's accumulators its registers;
* the ring: each product's instantiation holds at least four stages of
  1024-byte aligned tiles within 227 KB (:func:`gemm_ring`, ``GemmRing``
  in Python), and a stage's bytes are the bytes of the TMA boxes that
  fill it;
* the walk: :func:`persistent_walk`, the core's tile loops in Python (the
  source's loops are checked to be the ones it mirrors), over the tiles
  and grid of each product's launch (:func:`gemm_plan`), covers every
  (row tile, column tile) exactly once, each block's tiles in row-major
  order and dealt to its two consumers in turn, at every R of ``ROWS``
  and every (C, F) that phase 3c runs or ``padded_widths`` gives, on an
  H100's 132 SMs and on other grids;
* the maps: every TMA box's global row stride is a multiple of 16 bytes
  and its box at most 256 rows at those widths;
* the float32 path (3xTF32 on ``wgmma``): its mirrors (a stage's K, each
  product's tile, B's two planes, the partial sums), a consumer's
  registers with its partials counted, every instantiation's ring within
  227 KB, the walk and the maps at its padded widths, the workspace
  regions in the order the sources carve them, and the weight split in
  torch (``split_planes``): the kernels' three TF32 products from the hi
  and lo planes are those from the raw weight bit for bit.
"""

import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pevit_tpu_torch.ops import attention as ta
from pevit_tpu_torch.ops import fused_mlp as tf
from pevit_tpu_torch.ops._build import CSRC

REPO = Path(__file__).resolve().parents[1]


def _text(name: str) -> str:
    return " ".join((CSRC / name).read_text().split())  # one space a gap


CORE, FWD, BWD = _text("wgmma_gemm.cuh"), _text("fused_mlp_fwd.cu"), _text("fused_mlp_bwd.cu")
# each product's source and the constant naming its tile width
PRODUCT_SOURCE = {"fc": (FWD, "FC_TILE_N"), "proj": (FWD, "PROJ_TILE_N"),
                  "dh": (BWD, "DH_TILE_N"), "du": (BWD, "DU_TILE_N")}
F32_SOURCE = {"fc": (FWD, "FC_F32_TILE_N"), "proj": (FWD, "PROJ_F32_TILE_N"),
              "dh": (BWD, "DH_F32_TILE_N"), "du": (BWD, "DU_F32_TILE_N")}


def _constant(text: str, name: str) -> int:
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", text)
    return int(value)


SMEM_BUDGET = _constant(_text("tma.cuh"), "SMEM_BUDGET")


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One bf16 product's launch: its tile width, products a tile, ring
    stages and dynamic shared memory, its (row, column) tiles and its grid,
    and its operands' TMA maps as (rows, columns, box rows) of row-major
    bf16 matrices: A's, then B's, for each product of the tile."""

    product: str
    tile_n: int
    products: int
    stages: int
    smem: int
    row_tiles: int
    col_tiles: int
    grid: int
    maps: tuple


def epi_bytes(out: int) -> int:
    """A consumer warp's staging buffer (``EpiBuf``) for output values of
    ``out`` bytes: 16 rows of 64 values, padded by 8."""
    return 16 * 72 * out


def gemm_ring(tile_n: int, out: int, planes: int = 1) -> tuple:
    """(stages, dynamic shared memory bytes) of the core's ring at a tile
    width, as ``GemmRing`` computes them: a stage holds an A tile (128 rows
    of 128 bytes) and a B tile of tile_n rows of 128 bytes for each of B's
    ``planes`` (float32: 2, its TF32 hi and lo) and a full and an empty
    mbarrier, after 1024 bytes of alignment slack and beside the consumer
    warps' staging buffers."""
    stage = (tf.GEMM_ROWS + planes * tile_n) * 128
    epis = tf.GEMM_CONSUMERS * 4 * epi_bytes(out)
    stages = min(tf.GEMM_MAX_STAGES, (SMEM_BUDGET - 1024 - epis) // (stage + 16))
    return stages, 1024 + stages * (stage + 16) + epis


def gemm_plan(product: str, R: int, C: int, F: int, dtype=torch.bfloat16) -> GemmPlan:
    """The launch of one of the bodies' products (K2's "fc", "proj"; K3's
    "dh", "du") in ``dtype`` over R rows at the widths C and F the kernel
    runs at (``padded_widths``), as ``launch_gemm`` makes it on an H100's
    SMs; float32 maps are (rows, columns, box rows) of float32 matrices, B
    twice a product (its hi and lo planes)."""
    f32 = dtype == torch.float32
    tile_n, products, b_mn, out = (tf.GEMM_PRODUCTS_F32 if f32 else tf.GEMM_PRODUCTS)[product]
    n, k = {"fc": (F, C), "proj": (C, F), "dh": (F, C), "du": (C, F)}[product]
    a = (R, k, tf.GEMM_ROWS)
    b = (k, n, 64) if b_mn else (n, k, tile_n)
    planes = tf.GEMM_F32_PLANES if f32 else 1
    stages, smem = gemm_ring(tile_n, out, planes)
    row_tiles, col_tiles = -(-R // tf.GEMM_ROWS), -(-n // tile_n)
    return GemmPlan(product, tile_n, products, stages, smem, row_tiles, col_tiles,
                    min(ta.H100_SMS, row_tiles * col_tiles), (a, *(b,) * planes) * products)


def _phase_3c_widths() -> tuple:
    """``chip_smoke.SHAPE_WIDTHS``, read from the script's text."""
    (value,) = re.findall(r"^SHAPE_WIDTHS = (\(.*\))$", (REPO / "chip_smoke.py").read_text(),
                          re.MULTILINE)
    return ast.literal_eval(value)


# R: one row, a part tile, a tile less one, one tile, the eval remainder,
# phase 5's tail, the ViT-B/32 training and serving batches and ViT-H/14's
# 32 x 257; (C, F): the models' widths, phase 3c's, and those
# padded_widths gives for them in bf16
ROWS = (1, 8, 127, 128, 400, 5800, 6400, 8224, 12800)
WIDTHS = sorted({tf.padded_widths(torch.bfloat16, c, f) for c, f in
                 ((768, 3072), (1024, 4096), (1280, 5120), *_phase_3c_widths())})
GRIDS = (1, 7, 131, ta.H100_SMS, 133)


def test_core_mirrors_match_the_source():
    assert _constant(CORE, "GEMM_BM") == tf.GEMM_ROWS == 128
    assert _constant(CORE, "GEMM_BK") == tf.GEMM_K == 64
    assert _constant(CORE, "GEMM_CONSUMERS") == tf.GEMM_CONSUMERS == 2
    assert _constant(CORE, "GEMM_PRODUCER_REGS") == tf.GEMM_PRODUCER_REGS
    assert _constant(CORE, "GEMM_CONSUMER_REGS") == tf.GEMM_CONSUMER_REGS
    assert _constant(CORE, "GEMM_MAX_STAGES") == tf.GEMM_MAX_STAGES
    assert SMEM_BUDGET == 232448 and "constexpr int SMEM_BUDGET" not in CORE
    assert "constexpr int GEMM_THREADS = (1 + GEMM_CONSUMERS) * 128;" in CORE


@pytest.mark.parametrize("product", sorted(tf.GEMM_PRODUCTS))
def test_product_mirrors_match_the_source(product):
    """Each product's kernel runs the core and its launcher launches it with
    the tile width, products a tile and B's layout that GEMM_PRODUCTS
    names."""
    text, const = PRODUCT_SOURCE[product]
    tile_n, products, b_mn, out = tf.GEMM_PRODUCTS[product]
    assert _constant(text, const) == tile_n
    args = f"{const}, {products}, {'true' if b_mn else 'false'}, {out}"
    assert f"gemm_persistent<{args}>( maps," in text
    assert f"launch_gemm<{args}>(gemm_{product}_bf16," in text


def test_registers_fit_an_sm():
    """setmaxnreg's counts are multiples of 8 within 24 and 256; the producer
    warpgroup and the consumers fill at most an SM's 65,536 registers, and
    with them the block launches at 168 registers a thread (ptxas's count
    at 384 threads, one block an SM); a consumer's float32 accumulators
    (a whole tile of 128 rows: the tile width a thread, for each product
    of a tile) leave it room."""
    for regs in (tf.GEMM_PRODUCER_REGS, tf.GEMM_CONSUMER_REGS):
        assert regs % 8 == 0 and 24 <= regs <= 256
    threads = 128 * (1 + tf.GEMM_CONSUMERS)
    total = 128 * (tf.GEMM_PRODUCER_REGS + tf.GEMM_CONSUMERS * tf.GEMM_CONSUMER_REGS)
    assert total <= 65536 and total == threads * (65536 // threads // 8 * 8)
    for tile_n, products, *_ in tf.GEMM_PRODUCTS.values():
        assert tf.GEMM_ROWS * tile_n * products // 128 <= 128 < tf.GEMM_CONSUMER_REGS
    for text in (FWD, BWD):
        assert "__launch_bounds__(GEMM_THREADS, 1)" in text


@pytest.mark.parametrize("product", sorted(tf.GEMM_PRODUCTS))
def test_every_instantiation_fits_four_stages(product):
    """``GemmRing`` computed in Python: the stage count, at least four, and
    the dynamic shared memory within 227 KB beside the consumer warps'
    staging buffers; each stage (A's 128 rows and B's tile width of
    128-byte rows) a whole number of the 128-byte swizzle's 1024-byte
    blocks, so every tile starts where the wgmma descriptors' layout does,
    and the staging buffers 16-byte aligned after the mbarriers; the wgmma
    widths built."""
    tile_n, _, _, out = tf.GEMM_PRODUCTS[product]
    stages, smem = gemm_ring(tile_n, out)
    stage = (tf.GEMM_ROWS + tile_n) * tf.GEMM_K * 2
    assert 4 <= stages <= tf.GEMM_MAX_STAGES and smem <= SMEM_BUDGET
    assert stage % 1024 == 0 and tf.GEMM_ROWS * tf.GEMM_K * 2 % 1024 == 0
    assert "static constexpr int FIT = (SMEM_BUDGET - SLACK - EPIS) / (STAGE + 16);" in CORE
    assert stages * (stage + 16) % 16 == 0 and epi_bytes(out) % 16 == 0
    assert f"struct Wgmma<{tile_n}> {{" in CORE
    assert "static_assert(STAGES >= 4 && SMEM <= SMEM_BUDGET" in CORE
    assert "static constexpr int EPI = 72 * OUT * 16;" in CORE
    assert {"fc": 6, "proj": 6, "dh": 8, "du": 5}[product] == stages


def persistent_walk(tiles: int, grid: int) -> tuple:
    """The core's tile loops, as the producer's and the consumers' loops take
    them: block i of ``grid`` walks tiles i, i + grid, ... in order, and
    deals tile j of its walk to consumer warpgroup j % GEMM_CONSUMERS.
    Returns three int arrays (block, consumer, tile), one entry a tile, by
    block and each block's in its walk's order."""
    tile = np.arange(tiles)
    block = tile % grid
    order = np.lexsort((tile, block))
    return block[order], (tile[order] // grid) % tf.GEMM_CONSUMERS, tile[order]


def test_the_walk_mirrors_the_kernels_loops():
    """The loops :func:`persistent_walk` mirrors: the producer and the
    consumers walk the same tiles from blockIdx.x by gridDim.x, each tile's
    first row and column from its index in row-major order, and the K
    steps and products of a tile in the same order (so the ring's stages
    come to the consumers as the producer fills them); a consumer skips
    the ring entries of the tiles the other takes; the grid is one block
    an SM, at most one a tile."""
    corner = "const int row0 = tile / col_tiles * GEMM_BM, n0 = tile % col_tiles * BN;"
    # the producer's, then the float32 consumers' and the bf16 consumers' walks
    steps = ("for (int ks = 0; ks < ksteps; ++ks) #pragma unroll "
             "for (int p = 0; p < NP; ++p, ++it) {")
    assert CORE.count(corner) == 3
    assert CORE.count(steps) == 2  # the producer's and the bf16 consumer's
    assert CORE.count("for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {") == 2
    assert ("for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) { "
            "if (j % GEMM_CONSUMERS != c) { // the other consumer's tile: its ring entries "
            "it += ksteps * NP; continue; }") in CORE
    assert "const int tiles = (R + GEMM_BM - 1) / GEMM_BM * col_tiles;" in CORE
    assert "kernel<<<(int)(tiles < sms ? tiles : sms), GEMM_THREADS, L::SMEM, s>>>" in CORE


@pytest.mark.parametrize("tiles", [1, 2, 3, 131, 132, 133, 264, 265, 600, 2400])
def test_the_consumers_turns_pair_up(tiles):
    """The consumers' turns at the main loop: the consumer of tile j > 0
    waits on its own named barrier (1 + c), and the consumer of tile j
    arrives on the other's (2 - c) when tile j + 1 exists; so in every
    block each barrier takes as many arrivals as waits, none left
    unmatched at the block's end, and the turns alternate."""
    assert ("if (j > 0) // this consumer's turn: the other has issued tile j - 1 "
            'asm volatile("bar.sync %0, %1;\\n" ::"r"(1 + c)') in CORE
    assert 'if (tile + gridDim.x < tiles) asm volatile("bar.arrive %0, %1;\\n" ::"r"(2 - c)' in CORE
    for grid in (1, 7, ta.H100_SMS):
        block, consumer, tile = persistent_walk(tiles, grid)
        for b in range(min(grid, tiles)):
            mine = consumer[block == b]
            waits = [1 + c for c in mine[1:]]
            arrivals = [2 - c for c in mine[:-1]]
            assert sorted(waits) == sorted(arrivals)
            assert (np.diff(mine) != 0).all()


@pytest.mark.parametrize("product", sorted(tf.GEMM_PRODUCTS))
@pytest.mark.parametrize("rows", ROWS)
def test_the_walk_covers_every_tile_once(product, rows):
    """At every (C, F) of ``WIDTHS``: each (row tile, column tile) once, a
    block only where it has a tile, each block's tiles in row-major order
    and each of them its block's (tile % grid), dealt to its consumers in
    turn (neither takes more than one tile more than the other); the
    launch's grid the H100's 132 SMs or the tile count, whichever is
    smaller."""
    for c, f in WIDTHS:
        plan = gemm_plan(product, rows, c, f)
        tiles = plan.row_tiles * plan.col_tiles
        assert plan.grid == min(ta.H100_SMS, tiles)
        n = f if product in ("fc", "dh") else c
        assert plan.col_tiles * plan.tile_n >= n > (plan.col_tiles - 1) * plan.tile_n
        assert plan.row_tiles * tf.GEMM_ROWS >= rows > (plan.row_tiles - 1) * tf.GEMM_ROWS
        for grid in (*GRIDS, plan.grid):
            block, consumer, tile = persistent_walk(tiles, grid)
            row_tile, col_tile = np.divmod(tile, plan.col_tiles)
            cover = np.bincount(row_tile * plan.col_tiles + col_tile, minlength=tiles)
            assert (cover == 1).all() and len(cover) == tiles
            assert block.max() == min(grid, tiles) - 1 and (tile % grid == block).all()
            same = np.diff(block) == 0
            assert (np.diff(row_tile * plan.col_tiles + col_tile)[same] > 0).all()
            place = np.arange(len(block)) - np.searchsorted(block, block)
            assert (consumer == place % tf.GEMM_CONSUMERS).all()


@pytest.mark.parametrize("product", sorted(tf.GEMM_PRODUCTS))
def test_every_box_is_16_byte_strided(product):
    """Each operand map at every width of ``WIDTHS`` and R of ``ROWS``: a
    row-major bf16 matrix whose row stride (its columns x 2 bytes) is a
    multiple of 16 bytes, as TMA requires, read in boxes of 64 columns (one
    128-byte swizzle row) by at most 256 rows; A's box is a tile's 128
    rows, B's the tile width (K-major) or 64 K rows (MN-major); and a
    stage's boxes fill exactly the bytes the producer tells its full
    mbarrier to expect.  The launchers encode the maps as mirrored here."""
    tile_n, products, b_mn, _ = tf.GEMM_PRODUCTS[product]
    for rows in ROWS:
        for c, f in WIDTHS:
            plan = gemm_plan(product, rows, c, f)
            assert len(plan.maps) == 2 * products
            for n_rows, n_cols, box in plan.maps:
                assert n_rows >= 1 and n_cols % 8 == 0 and n_cols * 2 % 16 == 0
                assert box <= 256 and box % 8 == 0
            (_, _, a_box), (_, _, b_box) = plan.maps[:2]
            b_boxes = tile_n // 64 if b_mn else 1
            assert a_box == tf.GEMM_ROWS and b_box == (64 if b_mn else tile_n)
            assert 64 * 2 * (a_box + b_boxes * b_box) == (tf.GEMM_ROWS + tile_n) * tf.GEMM_K * 2
    assert "err = matrix_map(&maps.a[p], a[p], R, K, GEMM_BM);" in CORE
    assert ("err = B_MN ? matrix_map(&maps.b[q], b[q], K, N, 64) : "
            "matrix_map(&maps.b[q], b[q], N, K, BN);") in CORE
    assert "const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};" in CORE
    assert "const cuuint32_t box[2] = {128 / sizeof(T), (cuuint32_t)box_rows};" in CORE
    assert "mbar_expect(bar, L::STAGE);" in CORE


@pytest.mark.parametrize("c,f", [(768, 3072), (1280, 5120)])
def test_the_column_tiles_fill_the_waves(c, f):
    """The tile widths' choice for N = C (proj, du): at the model shapes the
    share of a wave's SMs kept busy, tiles / (132 x waves), is no lower at
    128 columns than at 192 or 256 (fused_mlp_fwd.cu's comment)."""
    def busy(rows, width):
        tiles = -(-rows // 128) * -(-c // width)
        waves = -(-tiles // ta.H100_SMS)
        return tiles * min(1.0, c / (-(-c // width) * width)) / (ta.H100_SMS * waves)

    for rows in (6400, 8224, 12800):
        plan = gemm_plan("proj", rows, c, f)
        assert plan.tile_n == gemm_plan("du", rows, c, f).tile_n == 128
        assert busy(rows, 128) >= max(busy(rows, 192), busy(rows, 256))



# ---------------------------------------------------------------------------
# the float32 path: 3xTF32 on wgmma
# ---------------------------------------------------------------------------

# the core's rows of R in float32 (the fp32 serving artifacts' batches 1 and
# 8, phase 5's eval remainder and rows to ViT-B/32's serving batch) and its
# widths, padded as float32 pads them
F32_ROWS = (1, 50, 127, 400, 3200, 6400, 8224, 12800)
F32_WIDTHS = sorted({tf.padded_widths(torch.float32, c, f) for c, f in
                     ((768, 3072), (1024, 4096), (1280, 5120), *_phase_3c_widths())})
A_FRAGMENT_REGS = 2 * 2 * 4  # two groups' A, hi and lo, 4 values each


def test_f32_mirrors_match_the_source():
    """The float32 path's constants: a stage's K one 128-byte row of
    float32 (32 values, as bf16's 64), B in two planes, the partial sums in
    flight and the entries a turn; each product's tile width, products a
    tile and B K-major, as its kernel runs the core and its launcher
    launches it."""
    assert _constant(CORE, "GEMM_BK_TF32") == tf.GEMM_K_F32 == 32
    assert tf.GEMM_K_F32 * 4 == tf.GEMM_K * 2 == 128
    assert "static constexpr int BK = GEMM_BK_TF32, PLANES = 2;" in CORE
    assert tf.GEMM_F32_PLANES == 2
    assert _constant(CORE, "GEMM_TF32_PARTIALS") == tf.GEMM_F32_PARTIALS
    assert _constant(CORE, "GEMM_TF32_PAIR_PARTIALS") == tf.GEMM_F32_PAIR_PARTIALS
    assert "constexpr int P = NP == 1 ? GEMM_TF32_PARTIALS : GEMM_TF32_PAIR_PARTIALS;" in CORE
    assert _constant(CORE, "GEMM_TF32_CHUNK") == tf.GEMM_F32_CHUNK
    assert "constexpr int KS = GEMM_BK_TF32 / 8;" in CORE  # 4 k-steps of 8 an entry
    assert "float part[P][L::ACC];" in CORE and "float acc[NP][L::ACC];" in CORE
    for product, (text, const) in F32_SOURCE.items():
        tile_n, products, b_mn, out = tf.GEMM_PRODUCTS_F32[product]
        assert _constant(text, const) == tile_n and not b_mn and out == 4
        assert tf.GEMM_F32_CHUNK % products == 0
        args = f"{const}, {products}, false, {out}"
        assert f"gemm_persistent<{args}>( maps," in text
        assert f"launch_gemm<{args}>(gemm_{product}_tf32," in text
        assert f"GemmMaps<{products}, float> maps" in text
        assert f"struct WgmmaTf32<{tile_n}> {{" in CORE
        assert f"m64n{tile_n}k8.f32.tf32.tf32" in CORE


@pytest.mark.parametrize("product", sorted(tf.GEMM_PRODUCTS_F32))
def test_f32_consumer_registers_fit(product):
    """A float32 consumer thread holds its 64-row half's accumulators (64
    rows by the tile width over 128 threads, for each product), the partial
    sums in flight (half the tile width each) and their groups' A fragments
    (hi and lo, 4 values each) within setmaxnreg's 232, with room for its
    addresses; a tile of 128 columns would not fit."""
    tile_n, products, _, _ = tf.GEMM_PRODUCTS_F32[product]
    partials = partials_of(products)
    held = lambda n: 64 * n * products // 128 + partials * n // 2 + partials * 8
    assert held(tile_n) + 24 <= tf.GEMM_CONSUMER_REGS
    assert held(128) > tf.GEMM_CONSUMER_REGS


def partials_of(products: int) -> int:
    """The partial sums a float32 consumer rotates for a tile of
    ``products`` products."""
    return tf.GEMM_F32_PARTIALS if products == 1 else tf.GEMM_F32_PAIR_PARTIALS


def turns(entries: int, products: int) -> list:
    """The float32 consumer's turns over a tile's ring entries, as its loops
    take them: GEMM_F32_CHUNK entries a turn while that many are left, then
    ``products`` a turn."""
    out, at = [], 0
    while at + tf.GEMM_F32_CHUNK <= entries:
        out.append((at, tf.GEMM_F32_CHUNK))
        at += tf.GEMM_F32_CHUNK
    while at < entries:
        out.append((at, products))
        at += products
    return out


@pytest.mark.parametrize("ksteps", [1, 3, 4, 7, 8, 9, 24, 96, 160])
@pytest.mark.parametrize("products", [1, 2])
def test_f32_turns_add_each_group_once(ksteps, products):
    """A turn's bookkeeping (``turn`` in ``gemm_persistent``), in Python:
    group q of a turn is added when group q + P - 1 has been issued (and
    the last P - 1 after the turn's wait for all), so each k-step of each
    entry is added once, in order, into the accumulators of its product (u
    % NP: every turn starts at an entry that is a multiple of NP), and each
    entry's stage goes back to the producer once, in order, after its last
    group's add; at most P groups are in flight."""
    P, KS = partials_of(products), tf.GEMM_K_F32 // 8
    assert "if constexpr (q >= P - 1) add(std::integral_constant<int, q - (P - 1)>{});" in CORE
    assert "if (q % KS == KS - 1) release(it + q / KS);" in CORE
    assert "add_partial(acc[q / KS % NP], part[q % P]);" in CORE
    entries = ksteps * products
    added, released = [], []
    for start, count in turns(entries, products):
        assert start % products == 0
        groups = count * KS
        pending = []
        for q in range(groups):
            pending.append(q)
            assert len(pending) <= P
            if q >= P - 1:
                done = pending.pop(0)
                added.append((start + done // KS, done % KS, done // KS % products))
                if done % KS == KS - 1:
                    released.append(start + done // KS)
        for done in pending:
            added.append((start + done // KS, done % KS, done // KS % products))
            if done % KS == KS - 1:
                released.append(start + done // KS)
    assert added == [(e, k, e % products) for e in range(entries) for k in range(KS)]
    assert released == list(range(entries))


@pytest.mark.parametrize("product", sorted(tf.GEMM_PRODUCTS_F32))
def test_every_f32_instantiation_fits_four_stages(product):
    """Each float32 product's ring: A's 128 rows and B's two planes of the
    tile width, each 128-byte rows, 1024-byte aligned, at least four stages
    beside the float32 staging buffers, within 232,448 bytes."""
    tile_n, _, _, out = tf.GEMM_PRODUCTS_F32[product]
    stages, smem = gemm_ring(tile_n, out, tf.GEMM_F32_PLANES)
    stage = (tf.GEMM_ROWS + tf.GEMM_F32_PLANES * tile_n) * 128
    assert 4 <= stages <= tf.GEMM_MAX_STAGES and smem <= SMEM_BUDGET == 232448
    assert stage % 1024 == 0 and tile_n * 128 % 1024 == 0
    assert "static constexpr int STAGE = A_BYTES + GemmType<T>::PLANES * B_BYTES;" in CORE
    assert stages == 5


@pytest.mark.parametrize("product", sorted(tf.GEMM_PRODUCTS_F32))
@pytest.mark.parametrize("rows", F32_ROWS)
def test_the_f32_walk_covers_every_tile_once(product, rows):
    """At every float32 width: each (row tile, column tile) once, each
    block's tiles in row-major order, the grid the 132 SMs or the tiles;
    both consumers walk every tile of their block, each its 64-row half
    (its epilogue's rows), and release each stage (8 warps' arrivals)."""
    assert "epilogue(acc, row0 + 64 * c + 16 * warp, n0, epi);" in CORE
    assert "mbar_init(empty + 8 * s, TF32 ? 8 : 4);" in CORE
    for c, f in F32_WIDTHS:
        plan = gemm_plan(product, rows, c, f, torch.float32)
        tiles = plan.row_tiles * plan.col_tiles
        assert plan.grid == min(ta.H100_SMS, tiles)
        n = f if product in ("fc", "dh") else c
        assert plan.col_tiles * plan.tile_n >= n > (plan.col_tiles - 1) * plan.tile_n
        block, _, tile = persistent_walk(tiles, plan.grid)
        cover = np.bincount(tile, minlength=tiles)
        assert (cover == 1).all() and len(cover) == tiles
        assert (np.diff(tile)[np.diff(block) == 0] > 0).all()
        halves = [(r, 64 * h) for r in range(plan.row_tiles) for h in range(tf.GEMM_CONSUMERS)]
        assert sorted({r * tf.GEMM_ROWS + off for r, off in halves}) == list(
            range(0, plan.row_tiles * tf.GEMM_ROWS, 64))


@pytest.mark.parametrize("product", sorted(tf.GEMM_PRODUCTS_F32))
def test_every_f32_box_is_16_byte_strided(product):
    """Each float32 map at phase 3c's widths and the padded ones: a
    row-major float32 matrix whose row stride is a multiple of 16 bytes,
    read in boxes of 32 columns (one 128-byte row) by A's 128 rows or the
    tile width; B's two planes each (N x K, K-major); a stage's boxes fill
    the bytes the full mbarrier expects."""
    tile_n, products, _, _ = tf.GEMM_PRODUCTS_F32[product]
    for rows in F32_ROWS:
        for c, f in (*F32_WIDTHS, *_phase_3c_widths()):
            c, f = tf.padded_widths(torch.float32, c, f)
            plan = gemm_plan(product, rows, c, f, torch.float32)
            assert len(plan.maps) == (1 + tf.GEMM_F32_PLANES) * products
            for n_rows, n_cols, box in plan.maps:
                assert n_rows >= 1 and n_cols * 4 % 16 == 0 and box <= 256
            (_, _, a_box), (_, _, hi_box), (_, _, lo_box) = plan.maps[:3]
            assert (a_box, hi_box, lo_box) == (tf.GEMM_ROWS, tile_n, tile_n)
            assert tf.GEMM_K_F32 * 4 * (a_box + hi_box + lo_box) == (
                tf.GEMM_ROWS + tf.GEMM_F32_PLANES * tile_n) * 128


def split_planes(w: torch.Tensor, transpose: bool) -> tuple:
    """``split_tiles`` in torch: w's TF32 hi and lo parts (hi = rna(w), lo =
    rna(w - hi), the 13 low bits clear), as w lies or transposed."""
    from tests.test_torch_tf32_split import split

    hi, lo = split(w.T.contiguous() if transpose else w)
    return hi, lo


@pytest.mark.parametrize("product", ["fc", "proj", "dh_u", "dh_dy", "du"])
def test_the_weight_planes_give_the_same_products(product):
    """Each product's B planes as its launch's split job writes them
    (K-major: N rows of K), read back as the (K x N) operand, give the
    three TF32 products a k-step of ``tf32x3_matmul`` bit for bit as the
    raw weight does, and their low 13 bits are clear."""
    from tests.test_torch_tf32_split import tf32x3_matmul

    rng = np.random.default_rng(3)
    c, f, rows = 64, 256, 16
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    wfc, wproj = r(c, f) * c ** -0.5, r(f, c) * f ** -0.5
    # (A, the (K x N) weight of the product, the split job's source and
    # whether it transposes), as split_weights_fwd / _bwd's jobs
    a, b, src, transpose = {"fc": (r(rows, c), wfc, wfc, True),
                            "proj": (r(rows, f), wproj, wproj, True),
                            "dh_u": (r(rows, c), wfc, wfc, True),
                            "dh_dy": (r(rows, c), wproj.T, wproj, False),
                            "du": (r(rows, f), wfc.T, wfc, False)}[product]
    hi, lo = split_planes(src, transpose)
    assert hi.shape == lo.shape == b.T.shape  # N x K: K-major
    for plane in (hi, lo):
        assert not (plane.view(torch.int32) & 0x1FFF).any()
    got = tf32x3_matmul(a, b, planes=(hi.T, lo.T))
    assert torch.equal(got, tf32x3_matmul(a, b.contiguous()))


def _takes(text: str) -> list:
    """The float32 launcher's scratch regions in order, as element counts
    over R, C and F: each ``scratch.take<T>(n)`` of ``launch_f32`` (a loop
    of ``planes`` takes counted as often), T's size beside."""
    body = text[text.index("int launch_f32("):]
    body = body[:body.index("int launch_bf16(") if "int launch_bf16(" in body else None]
    out = []
    loop = re.search(r"float\* planes\[(\d+)\]; for \(float\*& plane : planes\) plane = "
                     r"scratch\.take<float>\(\(size_t\)(\w) \* (\w)\);", body)
    for m in re.finditer(r"(?:planes\[\d+\]; for .*?)?scratch\.take<(\w+)>\(\(size_t\)(\w)"
                         r"(?: \* (\w))?\)", body):
        out.append((m.group(1), m.group(2) + (m.group(3) or "")))
    if loop:
        out = [("float", loop.group(2) + loop.group(3))] * int(loop.group(1)) + out[1:]
    return out


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_f32_workspace_layouts_match_the_sources(kind):
    """``fwd_workspace_layout`` / ``bwd_workspace_layout`` in float32 carve
    the regions ``launch_f32`` takes, in its order and sizes (the planes
    C x F floats each), at the model widths and rows."""
    text, layout = {"fwd": (FWD, tf.fwd_workspace_layout),
                    "bwd": (BWD, tf.bwd_workspace_layout)}[kind]
    takes = _takes(text)
    assert len(takes) == {"fwd": 6, "bwd": 10}[kind]
    size = {"float": 4, "float2": 8}
    for rows, c, f in ((6400, 768, 3072), (50, 1280, 5120), (1, 100, 300)):
        dims = {"R": rows, "C": c, "F": f}
        regions = layout(torch.float32, rows, c, f)
        assert len(regions) == len(takes)
        for (_, _, nbytes), (kind_, expr) in zip(regions, takes):
            assert nbytes == size[kind_] * int(np.prod([dims[d] for d in expr]))
