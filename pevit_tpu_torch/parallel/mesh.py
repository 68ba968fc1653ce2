"""The device mesh over a world of ranks, one card each.

Counterpart of ``pevit_tpu/parallel/mesh.py``.  The reference lays a
("trial", "data", "model") mesh over its devices and lets GSPMD partition
one program; the port runs one process a card and writes the partition
out (PyTorch's idiom): each mesh axis is a process group, a rank takes its
share of the work, and the collectives are explicit (``collectives``).

* "trial": a sweep chunk's trials are cut into equal parts, one a trial
  rank; no collective until the results are gathered.
* "data": a full batch's rows are cut over the data ranks
  (:class:`RowShard`): the loss keeps the whole batch's denominator, the
  head's BN its statistics, and the gradients are summed over the axis.
* "model": Megatron tensor parallelism on a frozen CLIP tower
  (:func:`shard_params`, :func:`clip_param_specs`): ``in_proj``
  column-parallel by heads, ``out_proj`` row-parallel and summed, the MLP's
  ``c_fc`` / ``c_proj`` stored as column / row slices and gathered whole to
  run the fused MLP kernels.

``make_mesh`` builds the groups: every rank calls it with the same shape in
the same order (``dist.new_group`` is a collective of the whole world).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..core.layers import ShardedAttention, ShardedMLP
from ..utils import dist as comm
from .collectives import LONE, Axis, gather_rows, local_rows, row_bounds, sum_over
from .collectives import traced_gather_rows, traced_local_rows

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (trial, data, model) mesh over the world's first
    ``n_trial * n_data * n_model`` ranks, as this rank sees it: each axis
    its line through this rank.  A rank past the mesh (``member`` False)
    sits out of the work and takes its results."""

    shape: tuple
    trial: Axis = LONE
    data: Axis = LONE
    model: Axis = LONE
    member: bool = True

    def rank_of(self, t: int, d: int, m: int) -> int:
        """The global rank at mesh coordinates (t, d, m)."""
        _, n_d, n_m = self.shape
        return (t * n_d + d) * n_m + m


_MESHES: dict = {}


def make_mesh(n_data: int = -1, n_model: int = 1, n_trial: int = 1) -> Mesh:
    """The (trial, data, model) mesh of that shape over the world's ranks
    (``n_data`` -1: every rank left over), rank r at coordinates
    ``divmod`` of r in that order, as the reference's device mesh
    (``reshape(n_t, n_d, n_m)``).  Built once a shape for the life of the
    process's world; a collective of the whole world the first time."""
    world = comm.world_size()
    if n_data == -1:
        n_data = max(1, world // (n_model * n_trial))
    shape = (n_trial, n_data, n_model)
    size = n_trial * n_data * n_model
    if size > world:
        raise ValueError(f"a {shape} mesh needs {size} ranks, the world has {world}")
    if shape in _MESHES:
        return _MESHES[shape]
    me = comm.rank()
    axes = []
    for a, width in enumerate(shape):
        if width == 1:
            axes.append(LONE)
            continue
        mine = LONE
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for fixed in _product(others):
            ranks = []
            for k in range(width):
                c = list(fixed)
                c.insert(a, k)
                ranks.append((c[0] * n_data + c[1]) * n_model + c[2])
            group = dist.new_group(ranks)
            if me in ranks:
                mine = Axis(group, width, ranks.index(me))
        axes.append(mine)
    mesh = Mesh(shape, *axes, member=me < size)
    _MESHES[shape] = mesh
    return mesh


def _product(ranges):
    out = [()]
    for r in ranges:
        out = [o + (i,) for o in out for i in r]
    return out


# -- tensor parallelism on the CLIP tower ----------------------------------

def _block_leaf_spec(path: tuple) -> tuple:
    """The tensor-parallel spec of one block leaf, at its lone shape: the
    axis of each dimension, "model" where it is cut (the reference's
    ``_block_leaf_spec`` without its stacked layer axis)."""
    leaf, parent = path[-1], path[-2] if len(path) >= 2 else ""
    grand = path[-3] if len(path) >= 3 else ""
    if leaf == "kernel":
        if (grand, parent) in (("attn", "in_proj"), ("mlp", "c_fc")):
            return (None, "model")  # (C, 3C) / (C, F) column-parallel
        if (grand, parent) in (("attn", "out_proj"), ("mlp", "c_proj")):
            return ("model", None)  # (C, C) / (F, C) row-parallel
    if leaf == "bias" and parent in ("in_proj", "c_fc"):
        return ("model",)
    return ()


def clip_param_specs(clip: nn.Module) -> dict:
    """``{parameter name: spec}`` of a CLIP module, the reference's table
    (``pevit_tpu/parallel/mesh.py:33-65``): in every transformer block
    (both towers) ``in_proj`` and ``c_fc`` column-parallel, ``out_proj``
    and ``c_proj`` row-parallel, the rest replicated (``()``)."""
    specs = {}
    for name, _ in clip.named_parameters():
        path = tuple(name.split("."))
        specs[name] = _block_leaf_spec(path) if "blocks" in path else ()
    return specs


def _tp_block(blk: nn.Module, n_head: int, axis: Axis) -> nn.Module:
    out = nn.Module()
    out.ln_1, out.ln_2 = blk.ln_1, blk.ln_2
    out.attn = ShardedAttention(blk.attn, n_head, axis)
    out.mlp = ShardedMLP(blk.mlp, axis)
    return out


def shard_params(clip: nn.Module, mesh: Mesh, n_head: int) -> nn.Module:
    """The frozen CLIP visual tower as this model rank holds it, under
    ``visual`` (what ``encode_image`` reads): every block's attention with
    the q, k and v columns of this rank's heads and the matching rows of
    ``out_proj`` (:class:`ShardedAttention`), its MLP as this rank's
    column / row slices (:class:`ShardedMLP`); the embeddings, LayerNorms
    and projection shared with ``clip``.  The reference shards the whole
    tree (``clip_param_specs``); the text tower takes no part in training,
    so the port leaves it whole."""
    axis = mesh.model
    src = clip.visual
    vis = nn.Module()
    for name, child in src.named_children():
        if name != "blocks":
            vis.add_module(name, child)
    for name, p in src.named_parameters(recurse=False):
        vis.register_parameter(name, p)
    vis.blocks = nn.ModuleList(_tp_block(b, n_head, axis) for b in src.blocks)
    out = nn.Module()
    out.visual = vis
    return out


# -- rows over the data axis -----------------------------------------------

class RowShard:
    """One call's batch cut over the data axis: this rank takes rows
    ``bounds[i]:bounds[i + 1]`` of every trial's B rows.

    ``hooks`` wraps a method's attention delta so that it reads the whole
    batch: KAdaptation's and LoRA's raw-reshape scramble (quirk 4) gives a
    row its delta from a token range of every row, so the LN'd block input
    is gathered over the axis, the delta computed whole (the per-trial
    dropout on H is drawn alike on every rank: the same generator state),
    and this rank's rows kept; the gradient flows back to each rank's rows
    through the gather's transpose."""

    def __init__(self, axis: Axis, rows: int):
        bounds = row_bounds(rows, axis.size)
        self.axis = axis
        self.sizes = tuple(b - a for a, b in zip(bounds, bounds[1:]))
        self.lo, self.hi = bounds[axis.index], bounds[axis.index + 1]

    def take(self, x):
        """This rank's rows of a batch's leading axis."""
        return x[self.lo:self.hi]

    def gather(self, y: torch.Tensor, lead: int = 1) -> torch.Tensor:
        """Every rank's rows of ``y`` (:func:`collectives.gather_rows`)."""
        return gather_rows(y, self.axis, self.sizes, lead)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the axis, differentiable."""
        return sum_over(x, self.axis)

    def hooks(self, hooks, trials: int):
        lead = max(trials, 1)
        return _whole_batch_delta(hooks, lambda x: self.gather(x, lead),
                                  lambda d: local_rows(d, self.axis, self.sizes, lead))


def row_shard(mesh: Optional[Mesh], rows: int) -> Optional[RowShard]:
    """A batch of ``rows`` cut over ``mesh``'s data axis, or None where the
    mesh has none or the batch has fewer rows than it has ranks."""
    if mesh is None or mesh.data.size == 1 or rows < mesh.data.size:
        return None
    return RowShard(mesh.data, rows)


def _whole_batch_delta(hooks, gather, keep):
    """``hooks`` with its attention delta computed from the whole batch:
    ``gather`` the block input's rows, ``keep`` this rank's rows of the
    delta."""
    from ..core.clip import BlockHooks

    if hooks is None or hooks.attn_delta is None:
        return hooks
    inner = hooks.attn_delta

    def attn_delta(shared, layer, generator, x):
        dq, dv = inner(shared, layer, generator, gather(x))
        return keep(dq), keep(dv)

    return BlockHooks(attn_delta=attn_delta, mlp_post=hooks.mlp_post)


class TracedRowShard:
    """:class:`RowShard` inside an exported serving program of ``n`` equal
    parts: the part's index is the int64 tensor ``index``, an input of the
    program, and the gather an exportable ``all_reduce``
    (:func:`collectives.traced_gather_rows`), so one artifact serves every
    rank."""

    def __init__(self, n: int, index: torch.Tensor, group):
        self.n, self.index, self.group = n, index, group

    def hooks(self, hooks, trials: int):
        return _whole_batch_delta(
            hooks, lambda x: traced_gather_rows(x, self.n, self.index, self.group),
            lambda d: traced_local_rows(d, self.n, self.index))


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of ``x`` over the data axis (the reference's
    ``shard_batch``, ``P("data")``)."""
    return RowShard(mesh.data, x.shape[0]).take(x)


def replicate(x, mesh: Optional[Mesh] = None):
    """A replicated value: every rank holds all of it, so it is ``x``."""
    return x


__all__ = ["Mesh", "RowShard", "TracedRowShard", "clip_param_specs", "make_mesh", "replicate",
           "shard_batch", "shard_params"]
