"""The port's sweep and ``run_method`` against pevit_tpu/train/sweep.py,
driven by the fake task of tests/test_sweep_semantics.py:

* ``hyperparameter_sweep_lr`` picks the same (lr, wd) as the JAX sweep and
  asks the task for the same chunks of jobs, on the 8 score surfaces;
* a trial failing with anything but a device error scores 0.0; a chunk of
  more than one trial that runs out of card memory is halved, down to a
  single trial, whose running out of memory raises; every other device
  error (a kernel that fails to build, refuses its inputs or fails to
  launch, an accelerator error, a plain RuntimeError of a CUDA error)
  raises, on a chunk of 8 and on a chunk of 1, and is never halved; an
  nvcc failure inside a chunk aborts the whole sweep;
* the score cache replays a finished sweep without training and resumes a
  cut one, and its fingerprint follows the reference's invalidation rules,
  for arrays and tensors alike, and also hashes the PEFT method: two
  commands run into one output directory keep their own sweeps;
* ``run_method`` hands the task the same final run as JAX's ``run_method``
  (merged train+val or not, the patch-camelyon regeneration), with tensors
  on the port's side, and saves the trained state under TPU.CHECKPOINT_DIR.
"""

import collections
import inspect
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu.train import sweep as jsweep
from pevit_tpu_torch.config import get_default_config
from pevit_tpu_torch.ops import _build
from pevit_tpu_torch.ops._build import KernelBuildError, KernelInputError, KernelLaunchError
from pevit_tpu_torch.ops.fused_mlp import _check_aligned
from pevit_tpu_torch.peft.base import PeftConfig
from pevit_tpu_torch.train import sweep as psweep
from pevit_tpu_torch.train.sweep_cache import SweepCache, open_sweep_cache, sweep_fingerprint

from .test_sweep_semantics import FakeTask as _FakeTask


class FakeTask(_FakeTask):
    """The JAX sweep tests' fake task, with the PEFT method that keys the
    port's score cache."""

    static = SimpleNamespace(peft_cfg=PeftConfig(method="kadaptation"))


def _surface(seed):
    rng = np.random.default_rng(seed)
    lr_star, wd_star = 10 ** rng.uniform(-6, -1), 10 ** rng.uniform(-6, 6)

    def score_fn(lr, wd):
        d = (np.log10(lr / lr_star)) ** 2 + 0.1 * (np.log10(wd / wd_star)) ** 2
        return float(100 * np.exp(-d / 4))

    return score_fn


def _cfg(make, **tpu):
    cfg = make()
    cfg.defrost()
    for k, v in tpu.items():
        cfg.TPU[k] = v
    return cfg


@pytest.mark.parametrize("wd_search_left", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sweep_picks_and_asks_as_jax(seed, wd_search_left):
    score_fn = _surface(seed)
    tasks = {}
    picks = {}
    for name, make, mod in (("jax", jax_defaults, jsweep), ("port", get_default_config, psweep)):
        cfg = _cfg(make, SWEEP_PARALLEL_TRIALS=8)
        cfg.TRAIN.WD_SEARCH_LEFT = wd_search_left
        tasks[name] = FakeTask(cfg, score_fn)
        picks[name] = mod.hyperparameter_sweep_lr(tasks[name], (None,) * 4, cfg)
    assert picks["port"] == picks["jax"]
    assert tasks["port"].calls == tasks["jax"].calls
    assert 42 <= sum(len(c) for c in tasks["port"].calls) <= 90


def test_non_device_error_scores_zero():
    class BoomTask(FakeTask):
        def train_trials(self, hparams, *a, **k):
            self.calls.append(list(hparams))
            raise RuntimeError("boom")

    task = BoomTask(get_default_config(), lambda lr, wd: 1.0)
    assert psweep._run_stage(task, [(0.1, 1.0), (0.2, 2.0)], (None,) * 4, 1, 0, 8) == [0.0, 0.0]


def _device_errors():
    errors = [torch.cuda.OutOfMemoryError("CUDA out of memory"), KernelLaunchError("launch"),
              KernelBuildError("nvcc failed"), KernelInputError("unaligned bf16 rows"),
              RuntimeError("CUDA error: an illegal memory access was encountered")]
    if hasattr(torch, "AcceleratorError"):
        errors.append(torch.AcceleratorError("CUDA error: an illegal memory access"))
    return errors


@pytest.mark.parametrize("width", [8, 1])
@pytest.mark.parametrize("error", _device_errors(), ids=lambda e: type(e).__name__)
def test_device_error_raises_and_is_never_halved(width, error, caplog):
    """A chunk of more than one trial that runs out of card memory is split
    in halves, as the reference splits a chunk that fails on its device,
    down to single trials, whose running out of memory aborts the sweep;
    every other device error raises at once, from a chunk of any width, and
    is never halved."""
    class DeviceTask(FakeTask):
        def train_trials(self, hparams, *a, **k):
            self.calls.append(list(hparams))
            raise error

    task = DeviceTask(get_default_config(), lambda lr, wd: 1.0)
    jobs = [(float(i), float(i) / 10) for i in range(width)]
    with pytest.raises(type(error)):
        psweep._run_stage(task, jobs, (None,) * 4, end_epoch=1, seed=0, max_parallel=8)
    if isinstance(error, torch.cuda.OutOfMemoryError) and width > 1:
        # 8 -> 4 + 4 -> 2 + 2 -> 1 + 1: the first single trial raises
        assert task.calls == [jobs, jobs[:4], jobs[:2], jobs[:1]]
        assert "sweep chunk of 8 ran out of card memory" in caplog.text
        assert "splitting to 4+4" in caplog.text
    else:
        assert task.calls == [jobs]


def test_a_chunk_out_of_memory_finishes_in_halves():
    """A chunk of 8 that runs out of card memory at more than 2 trials runs
    as four chunks of 2, every trial scored as it would be unhalved."""
    class TightTask(FakeTask):
        def train_trials(self, hparams, *a, **k):
            if len(hparams) > 2:
                self.calls.append(list(hparams))
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return super().train_trials(hparams, *a, **k)

    score = lambda lr, wd: lr + wd
    task = TightTask(get_default_config(), score)
    jobs = [(float(i), float(i) / 10) for i in range(8)]
    got = psweep._run_stage(task, jobs, (None,) * 4, end_epoch=1, seed=0, max_parallel=8)
    assert got == [score(*j) for j in jobs]
    assert task.calls == [jobs, jobs[:4]] + [jobs[i:i + 2] for i in (0, 2)] + [jobs[4:]] + [
        jobs[i:i + 2] for i in (4, 6)]


def test_kernel_build_failure_aborts_the_sweep(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: this nvcc always fails'\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parents[1]))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    kernel = _build.Kernel("attention_fwd", "attention_fwd.cu", [], replaces="")

    class BuildingTask(FakeTask):
        def train_trials(self, hparams, *a, **k):
            self.calls.append(list(hparams))
            kernel.launch()  # builds the library first, with the failing nvcc

    cfg = _cfg(get_default_config, SWEEP_PARALLEL_TRIALS=8)
    task = BuildingTask(cfg, lambda lr, wd: 1.0)
    with pytest.raises(KernelBuildError, match="always fails"):
        psweep.hyperparameter_sweep_lr(task, (None,) * 4, cfg)
    assert len(task.calls) == 1 and len(task.calls[0]) == 8 and kernel.launches == 0


def test_kernel_wrappers_refuse_inputs_with_kernel_input_error():
    x = torch.zeros(65, dtype=torch.bfloat16)
    _check_aligned("fused MLP forward", x[:64])
    with pytest.raises(KernelInputError, match="16-byte"):
        _check_aligned("fused MLP forward", x[1:])
    assert psweep.is_device_error(KernelInputError("x"))
    assert not psweep.is_device_error(RuntimeError("boom"))
    assert not psweep.is_device_error(ValueError("CUDA error: not a RuntimeError"))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (16, 8, 8, 3), dtype=np.uint8), rng.integers(0, 4, 16).astype(np.int32),
            rng.integers(0, 255, (4, 8, 8, 3), dtype=np.uint8), rng.integers(0, 4, 4).astype(np.int32))


def test_cache_replays_and_resumes(tmp_path):
    cfg = _cfg(get_default_config, SWEEP_CACHE_DIR=str(tmp_path / "cache"), SWEEP_PARALLEL_TRIALS=8)
    score_fn = _surface(5)
    first = FakeTask(cfg, score_fn)
    got = psweep.hyperparameter_sweep_lr(first, _data(), cfg)
    n_first = sum(len(c) for c in first.calls)

    replay = FakeTask(cfg, lambda lr, wd: 1.0 / 0.0)  # any training call fails the test
    assert psweep.hyperparameter_sweep_lr(replay, _data(), cfg) == got and replay.calls == []

    (cache_file,) = list((tmp_path / "cache").iterdir())
    lines = cache_file.read_text().splitlines()
    cache_file.write_text("\n".join(lines[: len(lines) // 2]) + '\n{"lr": "1e-3", "wd"')
    resumed = FakeTask(cfg, score_fn)
    assert psweep.hyperparameter_sweep_lr(resumed, _data(), cfg) == got
    assert 0 < sum(len(c) for c in resumed.calls) < n_first


def test_fingerprint_invalidation_and_placement():
    cfg = get_default_config()
    data = _data()
    base = sweep_fingerprint(cfg, data, end_epoch=10, seed=0, method="kadaptation")
    fp = lambda c, d, e, s, m="kadaptation": sweep_fingerprint(c, d, e, s, m)
    assert fp(cfg, tuple(torch.from_numpy(a) for a in data), 10, 0) == base
    assert fp(cfg, data, 10, 1) != base
    assert fp(cfg, data, 11, 0) != base
    assert fp(cfg, _data(seed=5), 10, 0) != base
    assert fp(cfg, data, 10, 0, "lora") != base
    changed = cfg.clone()
    changed.TRAIN.BATCH_SIZE_PER_GPU += 1
    assert fp(changed, data, 10, 0) != base
    moved = cfg.clone()
    moved.OUTPUT_DIR, moved.TPU.CHECKPOINT_DIR, moved.TPU.SWEEP_CACHE_DIR = "/else", "/ck", "/c"
    assert fp(moved, data, 10, 0) == base
    assert open_sweep_cache(cfg, data, 10, 0, "kadaptation") is None  # 'auto' unresolved


def test_cache_keys_are_exact(tmp_path):
    c = SweepCache(str(tmp_path), "fp")
    c.put(1e-3, 0.5, 42.0)
    again = SweepCache(str(tmp_path), "fp")
    assert again.get(1e-3, 0.5) == 42.0 and again.get(1e-3, 0.5000001) is None and len(again) == 1


class RecordingTask(FakeTask):
    """Records what the final run is handed; satisfies both run_methods."""

    def train_trials(self, hparams, *a, **k):
        self.calls.append((list(hparams), [np.asarray(x) for x in a], dict(k)))
        self._last_state = ({"w": np.zeros((1, 3), np.float32)},)
        self.last_trainable = {"w": None}
        n = len(a[3])
        return [{"best_score": 50.0, "last_score": 40.0,
                 "best_logits": np.full((n, 4), 0.25, np.float32)}]

    def model_info(self, trainable):
        return {"n_trainable_params": 3}


@pytest.mark.parametrize("case", ["merge", "no_merge", "patch_camelyon"])
def test_run_method_hands_the_same_final_run(case):
    data = _data(1) + _data(2)[2:]
    calls = {}
    for name, make, mod, wrap in (("jax", jax_defaults, jsweep, np.asarray),
                                  ("port", get_default_config, psweep, torch.from_numpy)):
        cfg = _cfg(make)
        cfg.DATASET.MERGE_TRAIN_VAL_FINAL_RUN = case != "no_merge"
        cfg.TRAIN.END_EPOCH, cfg.TRAIN.EXTRA_FINAL_TRAIN_EPOCH, cfg.TRAIN.BEGIN_EPOCH = 3, 4, 1
        if case == "patch_camelyon":
            cfg.DATASET.DATASET, cfg.DATASET.NUM_SAMPLES_PER_CLASS = "patch-camelyon", 10000
        cfg.freeze()
        task = RecordingTask(cfg, lambda lr, wd: 0.0)
        arrays = tuple(wrap(x) for x in data)
        score, info = mod.run_method(task, arrays, cfg, no_tuning=True, lr=0.01, l2=0.5, seed=3,
                                     rebuild_data=lambda: tuple(wrap(x) for x in _data(7) + _data(8)[2:]))
        calls[name] = (task.calls, score, info, cfg.DATASET.NUM_SAMPLES_PER_CLASS)
    (jcalls, jscore, jinfo, jshots), (pcalls, pscore, pinfo, pshots) = calls["jax"], calls["port"]
    assert len(pcalls) == len(jcalls) == 1
    assert pcalls[0][0] == jcalls[0][0] and pcalls[0][2] == jcalls[0][2]
    for g, w in zip(pcalls[0][1], jcalls[0][1]):
        np.testing.assert_array_equal(g, w)
    assert pscore == jscore and pshots == jshots
    assert pinfo["best_lr"] == jinfo["best_lr"] and pinfo["best_l2_lambda"] == jinfo["best_l2_lambda"]
    np.testing.assert_array_equal(pinfo["best_logits"], jinfo["best_logits"])


def test_checkpoint_dir_raises(tmp_path):
    """TPU.CHECKPOINT_DIR saves the final run's trained state as
    ``step_{END_EPOCH + EXTRA_FINAL_TRAIN_EPOCH}.npz``; only an Orbax
    checkpoint directory, which the port cannot read, raises."""
    from pevit_tpu_torch.ckpt import restore_trainable
    from pevit_tpu_torch.train import Head

    class SavingTask(RecordingTask):
        def train_trials(self, *a, **k):
            out = super().train_trials(*a, **k)
            self.last_bundle = {"clip": None, "peft": None, "head": Head(4, 3)}
            return out

    cfg = _cfg(get_default_config, CHECKPOINT_DIR=str(tmp_path))
    cfg.TRAIN.END_EPOCH, cfg.TRAIN.EXTRA_FINAL_TRAIN_EPOCH = 3, 4
    task = SavingTask(cfg, None)
    psweep.run_method(task, _data(1) + _data(2)[2:], cfg, no_tuning=True, lr=0.1, l2=0.1)
    assert [f.name for f in tmp_path.iterdir()] == ["step_7.npz"]
    got = restore_trainable(str(tmp_path), task.last_bundle)
    assert sorted(got) == ["head.linear.bias", "head.linear.kernel", "head.logit_scale"]
    (tmp_path / "step_8").mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        restore_trainable(str(tmp_path), task.last_bundle)


def test_two_methods_in_one_output_dir_train_their_own_sweeps(tmp_path, monkeypatch):
    """Repair: the sweep cache was keyed by config, data, epochs and seed,
    and no config key names the method, so LoRA run after KAdaptation with
    the same flags into one OUTPUT_DIR (as scripts/*.sh run them) opened
    KAdaptation's file, replayed its scores and trained no sweep trial.
    Now each command writes its own file and LoRA trains every trial.  The
    JAX package keeps the old key: its ``sweep_fingerprint`` takes no method
    and gives both jobs one key (ROADMAP §3, standing divergences)."""
    import pevit_tpu.train
    from pevit_tpu.commands import kronecker_adaptation_clip as jax_kadapt
    from pevit_tpu.commands import lora_clip as jax_lora
    from pevit_tpu.train.sweep_cache import sweep_fingerprint as jax_fingerprint
    from pevit_tpu_torch.commands import kronecker_adaptation_clip, lora_clip
    from pevit_tpu_torch.train import TrainTask

    from .test_torch_cli import CPU, REPO, RESULT_INFO, _argv

    monkeypatch.chdir(REPO)
    trained = collections.Counter()
    train_trials = TrainTask.train_trials

    def counting(self, hparams, *a, **k):
        trained[self.static.peft_cfg.method] += len(hparams)
        return train_trials(self, hparams, *a, **k)

    monkeypatch.setattr(TrainTask, "train_trials", counting)
    cache_dir = tmp_path / "out" / "cifar-10" / "sweep_cache"
    kronecker_adaptation_clip.main(_argv(tmp_path, device=CPU))
    (kadapt_file,) = cache_dir.iterdir()
    lora_clip.main(_argv(tmp_path, device=CPU))
    files = set(cache_dir.iterdir())
    assert len(files) == 2 and kadapt_file in files
    (lora_file,) = files - {kadapt_file}
    lora_trials = {(r["lr"], r["wd"]) for r in map(json.loads, lora_file.read_text().splitlines())}
    assert 42 <= len(lora_trials) <= 90
    assert trained["lora"] == len(lora_trials) + 1  # every sweep trial, then the final run

    seen = {}

    def capture(name):
        def run_method(task, data, config, **kw):
            seen[name] = jax_fingerprint(config, data[:4], config.TRAIN.END_EPOCH, kw["seed"])
            return 0.0, {**RESULT_INFO, "best_logits": None}
        return run_method

    assert "method" not in inspect.signature(jax_fingerprint).parameters
    (tmp_path / "jax").mkdir()
    for name, cli in (("kadaptation", jax_kadapt), ("lora", jax_lora)):
        monkeypatch.setattr(pevit_tpu.train, "run_method", capture(name))
        cli.main(_argv(tmp_path / "jax"))
    assert seen["kadaptation"] == seen["lora"]


def test_semantics_version_keys_the_cache(monkeypatch):
    """Version 8: float32 attention at heads of up to 64 runs the
    persistent wgmma body, whose outputs can differ in their last bits, so
    a cache written by version 7 (bf16 attention from 641 to 768 tokens on
    the short ring) must not replay; nor one of version 6 (that range on
    the three-walk body), 5 (the
    three-walk body from 258 to 640 tokens), 4 (full fine-tuning and the
    auxiliary backbones' trials one after another), 3 (every trial alone)
    or 2 (before the fused-MLP backward's float32 body moved to the tensor
    cores)."""
    from pevit_tpu_torch.train import sweep_cache

    assert sweep_cache.SEMANTICS_VERSION == 8
    cfg, data = get_default_config(), _data()
    now = sweep_fingerprint(cfg, data, 10, 0, "kadaptation")
    for old in (7, 6, 5, 4, 3, 2):
        monkeypatch.setattr(sweep_cache, "SEMANTICS_VERSION", old)
        assert sweep_fingerprint(cfg, data, 10, 0, "kadaptation") != now
