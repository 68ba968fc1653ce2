"""Process identity and collectives for a world of processes, one per GPU.

Counterpart of ``pevit_tpu/utils/dist.py``.  The port follows PyTorch's own
idiom: one process per card, launched as ``torchrun`` launches, with the
world described by ``MASTER_ADDR`` / ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``.  :func:`initialize`
joins that world (NCCL between cards, gloo on the CPU) and is a no-op
without those variables, so a single process runs as it always has: rank
0 of a world of one.

The JAX reference runs one process per host, which drives every chip of
the host; its ``world_size()`` is the process count.  The port's ranks are
cards, so the reference's process count is :func:`host_count` here, and
that is what the LR rule (``config.update_config``) multiplies by.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

_LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
_DEVICE: Optional[torch.device] = None


def launched() -> bool:
    """True when the launcher's variables describe a world."""
    return all(v in os.environ for v in _LAUNCHER_VARS)


def initialize(backend: Optional[str] = None, device=None) -> Optional[torch.device]:
    """Join the world the launcher's variables describe; a no-op without
    them (or when this process already joined).  Returns this rank's device,
    or None where there is no world.

    ``device`` is this rank's device: ``None`` gives ``cuda:{LOCAL_RANK}``,
    ``"cpu"`` the CPU.  ``backend`` is NCCL on the card and gloo on the CPU
    unless given.  Ranks share a card only under gloo and only where the
    caller names the device; two NCCL ranks on one card raise here, before
    NCCL would fail on them."""
    global _DEVICE
    if dist.is_available() and dist.is_initialized():
        return _DEVICE
    if not launched():
        return None
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    named = device is not None
    dev = torch.device(device if named else f"cuda:{local}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device(f"cuda:{local}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL needs a CUDA device; the CPU takes gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank_} wants {dev} but CUDA is not available")
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank_} (LOCAL_RANK {local}) wants {dev}, but this host "
                               f"has {torch.cuda.device_count()} card(s)")
        if backend == "nccl" and (named and dev.index != local
                                  or int(os.environ.get("LOCAL_WORLD_SIZE", 1))
                                  > torch.cuda.device_count()):
            raise RuntimeError(
                f"two NCCL ranks would share {dev}: NCCL takes one card a rank "
                "(LOCAL_RANK indexes the cards); ranks share a card only under gloo")
        torch.cuda.set_device(dev)
    init = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    dist.init_process_group(backend, init_method=init, rank=rank_, world_size=world)
    _DEVICE = dev
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank())) if is_initialized() else 0


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size())) if is_initialized() else 1


def host_count() -> int:
    """The hosts of the world, ``WORLD_SIZE / LOCAL_WORLD_SIZE``: the
    reference's process count (one JAX process drives a host's chips)."""
    return max(1, world_size() // max(1, local_world_size()))


def is_main_process() -> bool:
    return rank() == 0


def head() -> bool:  # the reference's Comm.head
    return is_main_process()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


@contextlib.contextmanager
def main_process_first():
    """The block runs on the main process first, then on the others: what
    it writes to disk (a decoded dataset's cache) the others then read."""
    if not is_main_process():
        barrier()
    try:
        yield
    finally:
        if is_main_process():
            barrier()


def _comm_device() -> torch.device:
    """Where a small host-side value crosses the world: the card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_dict(input_dict: dict, average: bool = True) -> dict:
    """Scalar values summed (or averaged) over the world (reference
    utils/comm.py:111-137); the input as it is in a world of one."""
    if world_size() == 1:
        return dict(input_dict)
    keys = sorted(input_dict)
    vals = torch.tensor([float(input_dict[k]) for k in keys], dtype=torch.float64,
                        device=_comm_device())
    dist.all_reduce(vals)
    if average:
        vals = vals / world_size()
    return dict(zip(keys, vals.cpu().tolist()))


def all_gather_object(obj: Any) -> list:
    """Every rank's picklable ``obj``, in rank order (reference
    utils/comm.py:68-108); ``[obj]`` in a world of one."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def max_over_world(value: int) -> int:
    """The largest of every rank's ``value``; ``value`` in a world of one."""
    if world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())
