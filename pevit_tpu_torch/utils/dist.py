"""Process identity for the port's single process on one card.

Counterpart of ``pevit_tpu/utils/dist.py``.  The port runs one process, so
its rank is 0 and its world size 1 (the reference's LR x world-size rule in
``config.update_config`` then leaves TRAIN.LR as it is).  Several processes
wait for the parallel slice (ROADMAP).
"""

from __future__ import annotations


def rank() -> int:
    return 0


def world_size() -> int:
    return 1


def is_main_process() -> bool:
    return rank() == 0
