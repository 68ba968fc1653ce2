"""K1's persistent bf16 body (``attention_fwd_bf16_tma<NK>`` in
``pevit_tpu_torch/ops/csrc/attention_fwd.cu``), held on the CPU where its
CUDA cannot run:

* the launch plan: bf16 heads of up to 64 at every N from 1 to 257 (and
  every hd from 1 to 64) run the persistent body with the key count of the
  next instantiation, one block an SM of an H100 at most, and every other
  shape the body the constants name; ``check_grid`` counts its (batch,
  head) items;
* the mirrors: ``TMA_MAX_SEQ`` and the instantiations ``TMA_KEYS`` are
  the source's, and each instantiation's ring holds at least two stages
  within 227 KB;
* the walk: :func:`persistent_walk`, the kernel's loops in Python (the
  source's loops are checked to be the ones it mirrors), covers every
  (item, query tile) exactly once at every grid from 1 to 264 blocks, and
  deals each block's tiles to its two consumers in turn, so that neither
  takes more than one tile more than the other.
"""

import re

import numpy as np
import pytest
import torch

from pevit_tpu_torch.ops import attention as ta
from pevit_tpu_torch.ops._build import CSRC, KernelInputError
from pevit_tpu_torch.tools.attention_bodies import SHAPES

SOURCE = " ".join((CSRC / "attention_fwd.cu").read_text().split())  # one space a gap
SMEM_BUDGET = 232448  # the shared memory a block may use on Hopper


def _constant(name: str) -> str:
    (value,) = re.findall(rf"constexpr (?:int|bool) {name} = ([^;]+);", SOURCE)
    return value


def _layout(keys: int) -> dict:
    """``TmaBody<keys>`` of the source, computed in Python: query tiles,
    staged rows, a TMA box's rows, a stage's bytes, the stages and the
    dynamic shared memory."""
    tiles, rows = -(-keys // 64), -(-keys // 16) * 16
    stage = tiles * 64 * 128 + 2 * rows * 128
    stages = min(8, (SMEM_BUDGET - 1024) // (stage + 16))
    return {"tiles": tiles, "rows": rows, "box": rows if rows <= 256 else rows // 2,
            "stage": stage, "stages": stages, "smem": 1024 + stages * (stage + 16)}


def test_mirrors_match_the_source():
    assert int(_constant("TMA_MAX_SEQ")) == ta.TMA_MAX_SEQ == 257
    assert int(_constant("CONSUMERS")) == ta.TMA_CONSUMERS == 2
    tma = " ".join((CSRC / "tma.cuh").read_text().split())
    assert re.findall(r"constexpr int SMEM_BUDGET = (\d+);", tma) == [str(SMEM_BUDGET)]
    (keys,) = re.findall(r"constexpr int TMA_KEYS\[\] = \{([^}]+)\};", SOURCE)
    assert tuple(int(k) for k in keys.split(",")) == ta.TMA_KEYS
    launched = tuple(int(k) for k in re.findall(r"return launch_bf16_tma<(\d+)>\(a\);", SOURCE))
    assert launched == ta.TMA_KEYS
    assert max(ta.TMA_KEYS) >= ta.TMA_MAX_SEQ and list(ta.TMA_KEYS) == sorted(ta.TMA_KEYS)
    # the launcher's thresholds: N up to each instantiation but the last
    for keys in ta.TMA_KEYS[:-1]:
        assert f"if (N <= {keys}) return launch_bf16_tma<{keys}>(a);" in SOURCE


@pytest.mark.parametrize("keys", ta.TMA_KEYS)
def test_every_instantiation_fits_two_stages(keys):
    """A stage holds an item's query tiles, K and V rows padded to P V's
    k-steps of 16 in 128-byte rows; TMA's boxes take at most 256 rows, so
    the 272 rows of the 257-token instantiation come in two; its S rows
    (keys / 2 floats a thread) and wgmma's widths (multiples of 8 up to
    128 a product) hold."""
    lay = _layout(keys)
    assert keys % 8 == 0 and keys <= 272
    assert lay["box"] <= 256 and lay["rows"] % lay["box"] == 0 and lay["box"] % 8 == 0
    assert lay["stages"] >= 2 and lay["smem"] <= SMEM_BUDGET
    assert lay["stage"] % 1024 == 0  # each stage starts on the swizzle's 1024 bytes
    assert "static_assert(STAGES >= 2 && SMEM <= SMEM_BUDGET" in SOURCE


@pytest.mark.parametrize("hd", [8, 16, 24, 32, 40, 48, 56, 64])
def test_every_length_lands_on_the_body_the_constants_name(hd):
    """bf16 at hd 8 to 64: N from 1 to 257 on the persistent body at the
    next instantiation's key count, a block an SM at most; past it the
    shared-memory bodies; float32 never (its own persistent body,
    ``tests/test_torch_attention_f32_tma.py``)."""
    for n in range(1, ta.SMEM2_MAX_SEQ + 2):
        plan = ta.launch_plan(3, n, 4, hd, torch.bfloat16)
        if n <= ta.TMA_MAX_SEQ:
            want = "bf16_tma"
        elif n <= ta.SMEM_MAX_SEQ:
            want = "bf16_smem"
        elif n <= ta.SMEM2_MAX_SEQ:
            want = "bf16_smem2"
        else:
            want = "bf16_long"
        assert plan.body == want, (n, hd, plan)
        if want == "bf16_tma":
            assert plan.keys == min(k for k in ta.TMA_KEYS if k >= n)
            assert (plan.width, plan.hd, plan.blocks) == (64, hd, 12)
        else:
            assert plan.keys == 0
        assert ta.launch_plan(3, n, 4, hd, torch.float32).body == "f32_tma"


@pytest.mark.parametrize("hd", [1, 7, 20, 63])
def test_a_head_width_off_the_chunks_is_padded(hd):
    """hd that does not fill whole 16-byte chunks is padded to the next,
    and still runs the persistent body."""
    plan = ta.launch_plan(2, 197, 12, hd, torch.bfloat16)
    assert (plan.body, plan.keys, plan.hd) == ("bf16_tma", 200, -(-hd // 8) * 8)
    assert ta.launch_plan(2, 197, 12, 72, torch.bfloat16).body == "bf16_long"


@pytest.mark.parametrize("n,batch", [(n, b) for n, hd, heads, batches in SHAPES
                                     if hd == 64 and n <= 257 for b in batches])
def test_plan_at_the_timed_shapes(n, batch):
    """The rows phase 3 times: the key count, and the grid, one block an SM
    of an H100 SXM (132) or fewer at the smallest batches."""
    plan = ta.launch_plan(batch, n, 12, 64, torch.bfloat16)
    assert plan.body == "bf16_tma"
    assert plan.keys == {50: 56, 197: 200, 257: 264}[n]
    assert plan.blocks == min(ta.H100_SMS, 12 * batch)


@pytest.mark.parametrize("n,heads", [(197, 16), (50, 12), (257, 20)])
def test_check_grid_counts_the_items(n, heads):
    """The persistent body's grid is one block an SM, but it counts its
    (batch, head) items in a 32-bit int: the largest batch it takes, and
    one more image."""
    B = ta.MAX_BLOCKS // heads
    ta.check_grid(B, heads, n, torch.bfloat16, 64)
    assert ta.launch_plan(B, n, heads, 64, torch.bfloat16).blocks == ta.H100_SMS
    with pytest.raises(KernelInputError, match="blocks"):
        ta.check_grid(B + 1, heads, n, torch.bfloat16, 64)


# (B * H) counts: every one up to a wave of an H100 and one more, the ends
# of the second wave, and every row of attention_bodies.SHAPES
ITEM_COUNTS = sorted(set(range(1, 134)) | {263, 264, 265}
                     | {b * heads for n, hd, heads, batches in SHAPES for b in batches})


def persistent_walk(items: int, q_tiles: int, grid: int) -> tuple:
    """The persistent body's walk, as its kernel's loops take it: block i of
    ``grid`` walks items i, i + grid, ... in order (an item a (batch,
    head)), each of ``q_tiles`` query tiles, and deals tile k of its walk to
    consumer warpgroup k % TMA_CONSUMERS.  Returns four int arrays (block,
    consumer, item, tile), one entry a tile, by block and each block's in
    its walk's order."""
    item = np.repeat(np.arange(items), q_tiles)
    tile = np.tile(np.arange(q_tiles), items)
    block = item % grid
    k = item // grid * q_tiles + tile  # the tile's place in its block's walk
    order = np.lexsort((k, block))
    return block[order], k[order] % ta.TMA_CONSUMERS, item[order], tile[order]


def test_the_walk_mirrors_the_kernels_loops():
    """The loops :func:`persistent_walk` mirrors: the producer and each
    consumer walk the same items from blockIdx.x by gridDim.x, and a
    consumer takes tile k of its block's walk where k % CONSUMERS is its
    own."""
    walk = "for (int item = blockIdx.x; item < a.items; item += gridDim.x, ++it) {"
    assert SOURCE.count(walk) == 2
    assert SOURCE.count("for (int qt = 0; qt < q_tiles; ++qt, ++k) { "
                        "if (k % CONSUMERS != c) continue;") == 1
    assert "int k = 0, it = 0;" in SOURCE


@pytest.mark.parametrize("q_tiles", [1, 2, 4, 5])
def test_the_walk_covers_every_tile_once(q_tiles):
    """``persistent_walk`` at every grid from 1 to 264 blocks: each (item,
    query tile) once, a block only where it has an item, each block's tiles
    dealt to its consumers in turn (so no consumer takes more than one tile
    more than another) and its items walked in order, each of them its
    block's (item % grid)."""
    consumers = ta.TMA_CONSUMERS
    for items in ITEM_COUNTS:
        for grid in range(1, 265):
            block, consumer, item, tile = persistent_walk(items, q_tiles, grid)
            assert (np.bincount(item * q_tiles + tile, minlength=items * q_tiles) == 1).all()
            assert block.max() == min(grid, items) - 1 and (item % grid == block).all()
            first = np.searchsorted(block, block)  # where each tile's block starts
            place = np.arange(len(block)) - first
            assert (consumer == place % consumers).all()
            assert (np.diff(item)[np.diff(block) == 0] >= 0).all()
