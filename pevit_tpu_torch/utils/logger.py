"""Run logging: the per-run output dir and a file + console logger.

Counterpart of ``pevit_tpu/utils/logger.py`` (reference utils/utils.py:14-46):
the run's directory is ``OUTPUT_DIR/<dataset>/<cfg_name>`` and its log file
``<phase>_<timestamp>_rank<r>.txt``, so that ``read_results.py`` and
``read_txt.py`` read the port's output as they read the reference's.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from pathlib import Path

from . import dist as comm


def setup_logger(final_output_dir: str, rank: int, phase: str) -> str:
    time_str = time.strftime("%Y-%m-%d-%H-%M")
    log_file = f"{phase}_{time_str}_rank{rank}.txt"
    final_log_file = os.path.join(final_output_dir, log_file)
    head = f"%(asctime)-15s:[P:{rank}]:%(message)s"
    logging.basicConfig(filename=str(final_log_file), format=head, force=True)
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    console = logging.StreamHandler(stream=sys.stdout)
    console.setFormatter(logging.Formatter(head))
    logging.getLogger("").addHandler(console)
    return final_log_file


def create_logger(config, phase: str = "train") -> str:
    final_output_dir = Path(config.OUTPUT_DIR) / config.DATASET.DATASET / config.NAME
    final_output_dir.mkdir(parents=True, exist_ok=True)
    print(f"=> creating {final_output_dir}")
    setup_logger(str(final_output_dir), comm.rank(), phase)
    return str(final_output_dir)


def log_config(config, args=None) -> None:
    logging.info("=> configuration:\n%s", config.dump())
    if args is not None:
        logging.info("=> args: %s", vars(args))
