"""The NNCLR nearest-neighbour memory bank, a DeCLIP pretraining aid.

Counterpart of ``pevit_tpu/models/nnclr.py`` (reference
declip_model/utils/nnclr_modules/memory_bank.py:9-124 and
nn_memory_bank.py:10-65).  DeCLIP keeps one bank per modality and swaps
each feature for its nearest neighbour in the bank during pretraining
(declip_model/declip.py:168-169,276-282).

The bank is explicit state, a :class:`MemoryBankState` of tensors, passed
to and returned from plain functions; it is stored row-major ``(size,
dim)``, one key a row, so a query is one ``(n, dim) @ (dim, size)`` product
and an enqueue one row write.

Kept from the reference (memory_bank.py:70-87):

* the bank is queried BEFORE the enqueue, so a batch never matches itself
  (memory_bank.py:118-122);
* the wraparound truncates: where ``ptr + batch >= size`` only the first
  ``size - ptr`` rows are written and the pointer returns to 0; the tail of
  the batch is dropped, not wrapped (memory_bank.py:82-84);
* neighbours come back un-normalised, though the similarity is computed on
  normalised vectors (nn_memory_bank.py:56-63).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["MemoryBankState", "enqueue", "init_memory_bank", "nearest_neighbours", "nn_replace"]


@dataclasses.dataclass(frozen=True)
class MemoryBankState:
    """A ring buffer of unit-norm keys: ``bank`` (size, dim) float32 and
    ``ptr``, the next row written."""

    bank: torch.Tensor
    ptr: int = 0


def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)


def init_memory_bank(generator: torch.Generator, size: int, dim: int, *,
                     device=None) -> MemoryBankState:
    """Unit-norm random keys (memory_bank.py:66-68), drawn from ``generator``
    (on ``device``)."""
    if size <= 0:
        raise ValueError(f"Illegal memory bank size {size}, must be positive.")
    bank = torch.randn((size, dim), generator=generator, device=device)
    return MemoryBankState(bank=_l2_normalise(bank), ptr=0)


def enqueue(state: MemoryBankState, batch: torch.Tensor) -> MemoryBankState:
    """Write ``batch`` at the pointer, oldest keys out, with the reference's
    truncating wrap (memory_bank.py:71-87); the bank is not changed in place."""
    n = batch.shape[0]
    size = state.bank.shape[0]
    bank = state.bank.clone()
    keep = min(n, size - state.ptr)
    bank[state.ptr:state.ptr + keep] = batch[:keep].detach().to(bank.dtype)
    ptr = 0 if state.ptr + n >= size else state.ptr + n
    return MemoryBankState(bank=bank, ptr=ptr)


def nearest_neighbours(state: MemoryBankState, output: torch.Tensor, *,
                       topk: int = 1) -> torch.Tensor:
    """The ``topk`` bank keys nearest each row of ``output`` by cosine
    similarity, un-normalised (nn_memory_bank.py:53-65): ``(topk, n, dim)``."""
    sims = _l2_normalise(output) @ _l2_normalise(state.bank).T  # (n, size)
    idx = torch.topk(sims, topk, dim=1).indices  # (n, topk)
    return state.bank[idx].permute(1, 0, 2)


def nn_replace(state: MemoryBankState, output: torch.Tensor, *, update: bool,
               topk: int = 1) -> tuple:
    """One DeCLIP call (``NNMemoryBankModule.forward(output, update=...)``):
    the neighbours from the bank as it was, then the enqueue where
    ``update``.  Returns (neighbours, new state)."""
    nn = nearest_neighbours(state, output, topk=topk)
    if update:
        state = enqueue(state, output)
    return nn, state
