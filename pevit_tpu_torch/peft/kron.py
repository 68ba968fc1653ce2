"""Batched Kronecker-product math (counterpart of ``pevit_tpu/peft/kron.py``).

Each function also takes its operands stacked over a leading trial axis
(a batch of trials, ``TrainTask.train_trials``): a (T, P, ...) operand gives
a (T, ...) result, trial t's from trial t's slices.
"""

from __future__ import annotations

import torch


def batched_kron_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_p kron(a[p], b[p]).

    a: (P, i, j), b: (P, k, l) -> (i*k, j*l) with
    H[i*K + k, j*L + l] = sum_p a[p, i, j] * b[p, k, l]; or a (T, P, i, j)
    and b (T, P, k, l) -> (T, i*k, j*l).
    """
    *lead, _, I, J = a.shape
    *_, K, L = b.shape
    return torch.einsum("...pij,...pkl->...ikjl", a, b).reshape(*lead, I * K, J * L)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P, m, r) @ (P, r, n) -> (P, m, n), or with a leading trial axis
    (T, P, m, r) @ (T, P, r, n) -> (T, P, m, n)."""
    return torch.matmul(a, b)
