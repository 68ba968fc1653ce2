"""The trial axis of a stacked tower: the primitives a forward needs when a
parameter carries a leading trial axis.

A batch of T trials (``TrainTask.train_trials``) folds the trials' batches
into one, trial-major: rows ``t * B .. (t + 1) * B - 1`` of a (T*B, ...)
activation are trial t's.  Where the tower trains (``full_finetune``) every
trainable parameter is stacked (T, ...) over its lone shape
(``partition.stack_trials``); where it is frozen it is shared and runs on
the T*B rows unchanged.  A primitive tells the two apart by the weight's
rank against its lone rank (:func:`stacked`) and applies trial t's slice to
trial t's rows: a GEMM becomes one T-batched product (``torch.bmm``), an
elementwise weight broadcasts over a (T, B, ...) view.  A weight-free
operation (the attention core, a softmax, a pooling) runs on the folded
rows as it is, so its kernel launches once for the whole chunk.

A stack of one trial takes the lone operation on its only slice, so a
chunk of one makes exactly a lone trial's operator calls.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def stacked(w: torch.Tensor, lone_dim: int) -> int:
    """T where ``w`` carries a leading trial axis over its lone rank
    ``lone_dim``, else 0."""
    return w.shape[0] if w.dim() == lone_dim + 1 else 0


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a lone (in, out) weight; for a stacked (T, in, out)
    one, x is (T*B, ..., in) and trial t's rows take ``w[t]``, one
    T-batched product."""
    T = stacked(w, 2)
    if not T:
        return x @ w
    if T == 1:
        return x @ w[0]
    y = torch.bmm(x.reshape(T, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def broadcast(op: Callable, x: torch.Tensor, w: torch.Tensor, lone_dim: int) -> torch.Tensor:
    """``op(x, w)`` with ``w`` of rank ``lone_dim`` aligned to x's trailing
    axes; a stacked (T, ...) ``w`` gives trial t's slice to trial t's rows
    of x (T*B, ...)."""
    T = stacked(w, lone_dim)
    if not T:
        return op(x, w)
    if T == 1:
        return op(x, w[0])
    pad = (1,) * (x.dim() - 1 - lone_dim)
    y = op(x.reshape(T, -1, *x.shape[1:]), w.reshape(T, 1, *pad, *w.shape[1:]))
    return y.reshape(x.shape)


def add(x: torch.Tensor, w: torch.Tensor, lone_dim: int) -> torch.Tensor:
    """``x + w``, trial by trial where ``w`` is stacked (:func:`broadcast`)."""
    return broadcast(torch.add, x, w, lone_dim)


def mul(x: torch.Tensor, w: torch.Tensor, lone_dim: int) -> torch.Tensor:
    """``x * w``, trial by trial where ``w`` is stacked (:func:`broadcast`)."""
    return broadcast(torch.mul, x, w, lone_dim)


def rows(w: torch.Tensor, n: int, lone_dim: int) -> torch.Tensor:
    """A lone ``w`` repeated for ``n`` rows, (n, *w.shape); a stacked
    (T, ...) one gives each trial's slice to its n / T rows."""
    T = stacked(w, lone_dim)
    if not T:
        return w.expand(n, *w.shape)
    if T == 1:
        return w[0].expand(n, *w.shape[1:])
    return w.unsqueeze(1).expand(T, n // T, *w.shape[1:]).reshape(n, *w.shape[1:])


def rand_rows(shape: tuple, gens: Sequence, device) -> torch.Tensor:
    """Uniform draws of ``shape`` whose leading axis folds ``len(gens)``
    trials' rows: trial t's ``shape[0] / T`` rows from ``gens[t]``, each
    drawing the shape a lone trial of those rows draws, so that a batch of
    trials draws what each trial draws alone."""
    if len(gens) == 1:
        return torch.rand(shape, generator=gens[0], device=device)
    per = (shape[0] // len(gens),) + tuple(shape[1:])
    return torch.cat([torch.rand(per, generator=g, device=device) for g in gens])
