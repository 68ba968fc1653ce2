"""Batched Kronecker-product math (counterpart of ``pevit_tpu/peft/kron.py``)."""

from __future__ import annotations

import torch


def batched_kron_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_p kron(a[p], b[p]).

    a: (P, i, j), b: (P, k, l) -> (i*k, j*l) with
    H[i*K + k, j*L + l] = sum_p a[p, i, j] * b[p, k, l].
    """
    _, I, J = a.shape
    _, K, L = b.shape
    return torch.einsum("pij,pkl->ikjl", a, b).reshape(I * K, J * L)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P, m, r) @ (P, r, n) -> (P, m, n)."""
    return torch.bmm(a, b)
