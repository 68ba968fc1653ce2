"""The fused MLP's bf16 GEMM core (``gemm_persistent`` in
``pevit_tpu_torch/ops/csrc/wgmma_gemm.cuh``, under K2's ``fc`` and ``proj``
and K3's ``dh`` pair and ``du``), held on the CPU where its CUDA cannot
run:

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
  and its box at most 256 rows at those widths.
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


def gemm_ring(tile_n: int, out: int) -> tuple:
    """(stages, dynamic shared memory bytes) of the core's ring at a tile
    width, as ``GemmRing`` computes them: a stage holds an A tile (128 rows
    of 128 bytes) and a B tile (tile_n rows of 128 bytes) and a full and an
    empty mbarrier, after 1024 bytes of alignment slack and beside the
    consumer warps' staging buffers."""
    stage = (tf.GEMM_ROWS + tile_n) * tf.GEMM_K * 2
    epis = tf.GEMM_CONSUMERS * 4 * epi_bytes(out)
    stages = min(tf.GEMM_MAX_STAGES, (SMEM_BUDGET - 1024 - epis) // (stage + 16))
    return stages, 1024 + stages * (stage + 16) + epis


def gemm_plan(product: str, R: int, C: int, F: int) -> GemmPlan:
    """The launch of one of the bf16 bodies' products (K2's "fc", "proj";
    K3's "dh", "du") over R rows at the widths C and F the kernel runs at
    (``padded_widths``), as ``launch_gemm`` makes it on an H100's SMs."""
    tile_n, products, b_mn, out = tf.GEMM_PRODUCTS[product]
    n, k = {"fc": (F, C), "proj": (C, F), "dh": (F, C), "du": (C, F)}[product]
    a = (R, k, tf.GEMM_ROWS)
    b = (k, n, 64) if b_mn else (n, k, tile_n)
    stages, smem = gemm_ring(tile_n, out)
    row_tiles, col_tiles = -(-R // tf.GEMM_ROWS), -(-n // tile_n)
    return GemmPlan(product, tile_n, products, stages, smem, row_tiles, col_tiles,
                    min(ta.H100_SMS, row_tiles * col_tiles), (a, b) * products)


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
    steps = ("for (int ks = 0; ks < ksteps; ++ks) #pragma unroll "
             "for (int p = 0; p < NP; ++p, ++it) {")
    for text in (corner, steps):
        assert CORE.count(text) == 2, text
    assert CORE.count("for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {") == 1
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
    assert ("err = B_MN ? matrix_map(&maps.b[p], b[p], K, N, 64) : "
            "matrix_map(&maps.b[p], b[p], N, K, BN);") in CORE
    assert "const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};" in CORE
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

