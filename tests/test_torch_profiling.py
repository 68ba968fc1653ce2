"""The port's ``utils.profiling`` against the reference's: the same
``AverageMeter`` arithmetic, ``timed`` logging its block, and
``device_trace`` doing nothing without a directory and writing a
``torch.profiler`` trace with one."""

import json
import logging

import pytest
import torch

from pevit_tpu.utils.profiling import AverageMeter as JaxAverageMeter
from pevit_tpu_torch.utils.profiling import AverageMeter, device_trace, timed


def test_average_meter_matches_the_reference():
    got, want = AverageMeter(), JaxAverageMeter()
    for val, n in ((0.5, 3), (2.0, 1), (1.25, 4)):
        got.update(val, n)
        want.update(val, n)
        assert (got.val, got.sum, got.count, got.avg) == (want.val, want.sum, want.count,
                                                          want.avg)
    got.reset()
    assert (got.val, got.avg, got.sum, got.count) == (0.0, 0.0, 0.0, 0)


def test_timed_logs_its_block(caplog):
    with caplog.at_level(logging.INFO):
        with timed("export"):
            pass
    assert any(r.getMessage().startswith("export: ") for r in caplog.records)


def test_device_trace_is_a_no_op_without_a_directory(tmp_path):
    with device_trace("") as prof:
        torch.ones(4).sum()
    assert prof is None and not any(tmp_path.iterdir())


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("log_dir", ["", "trace"])
def test_device_trace_reraises(tmp_path, log_dir):
    with pytest.raises(ValueError, match="inside"):
        with device_trace(str(tmp_path / log_dir) if log_dir else ""):
            raise ValueError("inside")
