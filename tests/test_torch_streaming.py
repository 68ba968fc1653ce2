"""The streamed training path (``train/streaming.py``,
``TrainTask._train_trials_streaming``) against pevit_tpu's, fp32 on the
tiny ViT of ``test_torch_trainer`` (width 128, 2 layers, 64 px, patch 32)
with seeded non-zero PEFT factors and dropout 0:

* ``StreamingEpochRunner.run_epoch`` against the reference's on one bridged
  state, KAdaptation and LoRA, over an epoch with a natural tail and one
  with a size-1 tail: trained parameters and BN statistics at 1e-5;
* ``train_trials`` with ``TPU.MAX_DEVICE_DATA_GB = 1e-9`` (so the numpy
  train split streams), 1 and 2 trials with different (lr, wd), both
  packages initialising the trials alike: every epoch's val probabilities,
  ``best_score``, ``last_score`` and ``best_logits``;
* the streamed run against the port's batched preloaded run handed the streamed
  orders: equal, bit for bit, on the CPU;
* a spy: the runner hands ``prepack`` one batch of train rows at a time and
  gathers each batch once for two trials, and moves the split's bytes once
  an epoch;
* the merge of train and val for the final run, for the four mixes of host
  and device parts, against the reference's;
* the KAdaptation command end to end with every split in host memory
  against the same command on the preloaded path with the streamed orders.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu.peft import PeftConfig
from pevit_tpu.train import optim as jo
from pevit_tpu.train import streaming as js
from pevit_tpu.train import trainer as jt
from pevit_tpu_torch import bridge
from pevit_tpu_torch.commands import kronecker_adaptation_clip as port_cli
from pevit_tpu_torch.config import get_default_config
from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig
from pevit_tpu_torch.train import (
    TaskStatic,
    TrainState,
    TrainTask,
    combine,
    make_optimizer,
    partition,
    trainable_params,
    trainable_pred,
)
from pevit_tpu_torch.train import streaming as ps
from pevit_tpu_torch.train.sweep import merge_splits

from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)
from .test_torch_cli import REPO, _argv, _artifacts
from .test_torch_trainer import (
    B,
    K,
    LR,
    N_VAL,
    PORT_TINY,
    TINY,
    WD,
    WHOLE_RUN_LR,
    _cfg,
    _close,
    _data,
    _flat,
    _seed_peft,
    clip_params,  # noqa: F401  (fixture)
)

STREAM = 1e-9  # TPU.MAX_DEVICE_DATA_GB that streams every numpy split
METHODS = ["kadaptation", "lora"]


def _config(make, *, limit=STREAM, **train):
    cfg = _cfg(make, parity=False, **train)
    cfg.defrost()
    cfg.TPU.MAX_DEVICE_DATA_GB = limit
    cfg.freeze()
    return cfg


def _jax_task(clip_params, method, limit=STREAM):
    cfg = _config(jax_defaults, limit=limit)
    static = jt.TaskStatic.from_config(cfg, TINY, PeftConfig(method=method, kadapt_dropout_p=0.0))
    return jt.TrainTask(cfg, static, clip_params)


def _port_task(clip_params, method, limit=STREAM):
    cfg = _config(get_default_config, limit=limit)
    static = TaskStatic.from_config(cfg, PORT_TINY,
                                    PortPeftConfig(method=method, kadapt_dropout_p=0.0))
    clip = bridge.clip_from_jax(jax.tree.map(np.asarray, clip_params), PORT_TINY, device="cpu")
    return TrainTask(cfg, static, clip, device="cpu")


def _jax_init(task, key, method):
    """The reference's trial init with seeded non-zero PEFT factors."""
    trainable, frozen, bn = task.init_bundle(key)
    _seed_peft(trainable["peft"]["layers"], method)
    return trainable, frozen, bn


def _to_port(ptask, trainable, frozen, bn):
    """A JAX trial's (trainable, frozen, bn) as the port's partition."""
    bundle_np = jax.tree.map(np.asarray, jt.combine(trainable, frozen))
    bundle, bn_t = bridge.from_jax(bundle_np, jax.tree.map(np.asarray, bn), PORT_TINY,
                                   ptask.static.peft_cfg, device="cpu")
    bundle["clip"] = ptask.clip
    t_tree, f_tree = partition(bundle, trainable_pred(ptask.static))
    return t_tree, f_tree, bn_t


@pytest.mark.parametrize("n_train", [20, 17], ids=["natural-tail", "size-1-tail"])
@pytest.mark.parametrize("method", METHODS)
def test_run_epoch_matches_jax(clip_params, method, n_train):
    lr = WHOLE_RUN_LR.get(method, LR)
    jtask = _jax_task(clip_params, method)
    trainable, frozen, bn = _jax_init(jtask, jax.random.PRNGKey(1), method)
    images, labels = _data(n_train, seed=2)
    stack = lambda t: jax.tree.map(lambda a: a[None], t)
    opt_init, _ = jo.make_optimizer(jtask.static.optimizer, momentum=jtask.static.momentum,
                                    nesterov=jtask.static.nesterov)
    state = (stack(trainable), jax.vmap(opt_init)(stack(trainable)), stack(bn),
             jax.random.PRNGKey(4)[None])
    runner = js.StreamingEpochRunner(jtask, 1)
    state = runner.run_epoch(frozen, state, images, labels, jnp.asarray([lr], jnp.float32),
                             jnp.asarray([WD], jnp.float32), seed=5)

    ptask = _port_task(clip_params, method)
    t_tree, f_tree, bn_t = _to_port(ptask, trainable, frozen, bn)
    params = trainable_params(t_tree)
    p_init, _ = make_optimizer(ptask.static.optimizer, momentum=ptask.static.momentum,
                               nesterov=ptask.static.nesterov)
    prunner = ps.StreamingEpochRunner(ptask)
    (pstate,) = prunner.run_epoch([(combine(t_tree, f_tree), TrainState(
        params, p_init(params), bn_t, torch.Generator().manual_seed(0)))],
        images, labels, [lr], [WD], seed=5)
    assert prunner.batches == ps.epoch_steps(n_train, B) == 3 - (n_train == 17)
    got = _flat(bridge._tree_to_jax(pstate.params))
    want = _flat(jax.tree.map(lambda a: np.asarray(a)[0], state[0]))
    assert got.keys() == want.keys()
    init = _flat(jax.tree.map(np.asarray, trainable))
    for name in want:
        _close(got[name], want[name], f"trained {name}")
        if name.split(".")[-1] not in ("v_left", "v_right"):
            assert np.abs(want[name] - init[name]).max() > 100 * 1e-5 * np.abs(want[name]).max()
    for k in ("mean", "var"):
        _close(pstate.bn[k].numpy(), np.asarray(state[2][k])[0], f"bn {k}")


def _spy_evaluate(monkeypatch, task, out: list, jax_side: bool):
    """Each epoch's val probabilities of every trial: JAX's ``evaluate`` and
    the port's ``_evaluate_trials`` each evaluate all the trials of a call
    at once."""
    if jax_side:
        real = task.evaluate

        def spy(*a, **k):
            scores, probs = real(*a, **k)
            out.append(list(probs))
            return scores, probs

        monkeypatch.setattr(task, "evaluate", spy)
        return
    real = task._evaluate_trials

    def port_spy(*a, **k):
        scored = real(*a, **k)
        out.append([probs for _, probs in scored])
        return scored

    monkeypatch.setattr(task, "_evaluate_trials", port_spy)


def _epoch_probs(seen: list, trials: int, epochs: int) -> np.ndarray:
    """(trials, epochs, n, K) from the spied evaluate calls, all trials per
    call."""
    assert len(seen) == epochs
    return np.stack([np.stack([seen[e][t] for e in range(epochs)]) for t in range(trials)])


@pytest.mark.parametrize("hparams", [[(LR, WD)], [(LR, WD), (0.003, 1e-2)]],
                         ids=["1-trial", "2-trials"])
@pytest.mark.parametrize("method", METHODS)
def test_train_trials_streamed_matches_jax(clip_params, monkeypatch, method, hparams):
    if method == "lora":
        # LoRA's x32 delta makes fp32 training chaotic across the stacks
        # (test_torch_trainer's WHOLE_RUN_LR): at 1e-3 the two stacks' val
        # probabilities part by 1.4e-5 of their largest within two epochs
        hparams = [(lr * 0.03, wd) for lr, wd in hparams]
    seed, epochs, n_train = 3, 2, 20
    images, labels = _data(n_train, seed=6)
    val, val_labels = _data(N_VAL, seed=7)
    T = len(hparams)
    jtask = _jax_task(clip_params, method)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 17), T)
    inits = [_jax_init(jtask, keys[t], method) for t in range(T)]
    real_init = jtask.init_bundle

    def jax_init(key):
        trainable, frozen, bn = real_init(key)
        _seed_peft(trainable["peft"]["layers"], method)
        return trainable, frozen, bn

    monkeypatch.setattr(jtask, "init_bundle", jax_init)
    jseen, pseen = [], []
    _spy_evaluate(monkeypatch, jtask, jseen, True)
    with jax.default_matmul_precision("highest"):
        want = jtask.train_trials(hparams, images, labels, val, val_labels, end_epoch=epochs,
                                  seed=seed, keep_logits=True)

    ptask = _port_task(clip_params, method)

    def port_init(gen):
        t = (gen.initial_seed() - seed * 1_000_003) // 2
        return _to_port(ptask, *inits[t])

    monkeypatch.setattr(ptask, "init_bundle", port_init)
    _spy_evaluate(monkeypatch, ptask, pseen, False)
    got = ptask.train_trials(hparams, images, labels, val, val_labels, end_epoch=epochs,
                             seed=seed, keep_logits=True)
    gp, wp = _epoch_probs(pseen, T, epochs), _epoch_probs(jseen, T, epochs)
    assert gp.shape == wp.shape == (T, epochs, N_VAL, K)
    assert np.abs(wp[:, 1] - wp[:, 0]).max() > 1e-3  # training moved the probabilities
    for t in range(T):
        for e in range(epochs):
            _close(gp[t, e], wp[t, e], f"trial {t} epoch {e} val probs")
        assert got[t]["best_score"] == pytest.approx(want[t]["best_score"], abs=1e-9)
        assert got[t]["last_score"] == pytest.approx(want[t]["last_score"], abs=1e-9)
        _close(got[t]["best_logits"], want[t]["best_logits"], f"trial {t} best_logits")


def _preloaded_twin(ptask, hparams, images, labels, val, *, seed, epochs):
    """The port's preloaded run of the trials as one batch, handed the
    streamed orders: each trial's trained parameters and its (epochs, n, K)
    val logits."""
    T = len(hparams)
    fit_eval = ptask._fit_eval_fn(len(labels), epochs, len(val), T)
    orders = [ps.epoch_order(len(labels), seed * 1000 + e) for e in range(epochs)]
    batch = ptask._init_trials(seed, T)
    _, logits = fit_eval(batch.bundle, ptask.prepack(images), ptask._labels(labels),
                         ptask.prepack(val), batch.state, [[lr] * epochs for lr, _ in hparams],
                         [wd for _, wd in hparams], orders=orders)
    return [(trainable_params(trainable), logits[t].numpy())
            for t, (trainable, _) in enumerate(batch.trees)]


@pytest.mark.parametrize("method", METHODS)
def test_streamed_run_equals_the_preloaded_run_with_its_orders(clip_params, monkeypatch, method):
    hparams = [(LR * 0.1, WD), (LR * 0.3, 1e-2)]
    seed, epochs, n_train = 1, 2, 21
    images, labels = _data(n_train, seed=8)
    val, val_labels = _data(N_VAL, seed=9)
    ptask = _port_task(clip_params, method)
    seen = []
    _spy_evaluate(monkeypatch, ptask, seen, False)
    ptask.train_trials(hparams, images, labels, val, val_labels, end_epoch=epochs, seed=seed)
    streamed = _epoch_probs(seen, 2, epochs)
    last = trainable_params(ptask.last_trainable)
    twins = _preloaded_twin(_port_task(clip_params, method, limit=4.0), hparams, images, labels,
                            val, seed=seed, epochs=epochs)
    for t, (_, logits) in enumerate(twins):
        for e in range(epochs):
            z = logits[e] - logits[e].max(-1, keepdims=True)
            probs = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
            np.testing.assert_array_equal(streamed[t, e], probs)
    last_twin = twins[-1][0]
    assert last.keys() == last_twin.keys()
    for name, p in last.items():
        np.testing.assert_array_equal(p.detach().numpy(), last_twin[name].detach().numpy())


def test_a_batch_crosses_once_for_every_trial(clip_params, monkeypatch):
    n_train, epochs = 21, 2
    images, labels = _data(n_train, seed=10)
    val, val_labels = _data(6, seed=11)
    ptask = _port_task(clip_params, "kadaptation")
    rows, loading, runners = [], [False], []
    real_prepack, real_load = ptask.prepack, ps.StreamingEpochRunner._load
    real_init = ps.StreamingEpochRunner.__init__

    def prepack(x):
        if loading[0]:
            rows.append(len(x))
        return real_prepack(x)

    def load(self, *a):
        loading[0] = True
        try:
            return real_load(self, *a)
        finally:
            loading[0] = False

    def init(self, *a, **k):
        real_init(self, *a, **k)
        runners.append(self)

    monkeypatch.setattr(ptask, "prepack", prepack)
    monkeypatch.setattr(ps.StreamingEpochRunner, "_load", load)
    monkeypatch.setattr(ps.StreamingEpochRunner, "__init__", init)
    ptask.train_trials([(LR, WD), (LR, 1e-2)], images, labels, val, val_labels,
                       end_epoch=epochs)
    (runner,) = runners
    steps = ps.epoch_steps(n_train, B)
    assert rows == [B, B, n_train - 2 * B] * epochs  # one batch at a time
    assert runner.batches == steps * epochs  # once for both trials
    assert runner.h2d_bytes == epochs * images.nbytes


@pytest.mark.parametrize("train_dev,val_dev", [(False, False), (False, True), (True, False),
                                               (True, True)])
def test_merge_splits_matches_the_reference(train_dev, val_dev):
    """The final run's train+val merge (reference sweep.py:247-256): on the
    host when either part is numpy, on the device otherwise."""
    rng = np.random.default_rng(0)
    tx, vx = rng.integers(0, 256, (5, 4, 4, 3), np.uint8), rng.integers(0, 256, (3, 4, 4, 3),
                                                                      np.uint8)
    ty, vy = np.arange(5, dtype=np.int32), np.arange(3, dtype=np.int32)
    part = lambda a, dev: torch.from_numpy(a) if dev else a
    jpart = lambda a, dev: jnp.asarray(a) if dev else a
    got_x = merge_splits(part(tx, train_dev), part(vx, val_dev))
    got_y = merge_splits(part(ty, train_dev), part(vy, val_dev))
    on_host = not (train_dev and val_dev)
    for got, a, b in ((got_x, tx, vx), (got_y, ty, vy)):
        want = (np.concatenate([np.asarray(jpart(a, train_dev)), np.asarray(jpart(b, val_dev))])
                if on_host else jnp.concatenate([jpart(a, True), jpart(b, True)]))
        assert isinstance(got, np.ndarray) is on_host
        assert isinstance(want, np.ndarray) is on_host
        got = got if on_host else got.numpy()
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))


class _FinalRunSpy:
    """A task that records what the final run is handed."""

    def __init__(self):
        self.seen = None
        self.last_trainable = self.last_bundle = None

    def train_trials(self, hparams, x, y, *a, **k):
        self.seen = (x, y)
        return [{"best_score": 1.0, "last_score": 1.0, "best_logits": None}]

    def model_info(self, trainable):
        return {}


@pytest.mark.parametrize("train_dev,val_dev", [(False, False), (False, True), (True, False),
                                               (True, True)])
def test_the_final_run_merges_train_and_val_as_the_reference(train_dev, val_dev):
    """run_method's final run on train+val: a part on the card next to a
    host-resident one made ``torch.cat`` (or ``np.concatenate``) raise."""
    from pevit_tpu_torch.train import run_method

    rng = np.random.default_rng(1)
    tx, vx = rng.integers(0, 256, (6, 4, 4, 3), np.uint8), rng.integers(0, 256, (2, 4, 4, 3),
                                                                      np.uint8)
    ty, vy = np.arange(6, dtype=np.int32), np.arange(2, dtype=np.int32)
    part = lambda a, dev: torch.from_numpy(a) if dev else a
    cfg = get_default_config()
    task = _FinalRunSpy()
    run_method(task, (part(tx, train_dev), part(ty, train_dev), part(vx, val_dev),
                      part(vy, val_dev), tx, ty), cfg, no_tuning=True, lr=0.1, l2=0.0)
    x, y = task.seen
    on_host = not (train_dev and val_dev)
    assert isinstance(x, np.ndarray) is on_host and isinstance(y, np.ndarray) is on_host
    np.testing.assert_array_equal(np.asarray(x), np.concatenate([tx, vx]))
    np.testing.assert_array_equal(np.asarray(y), np.concatenate([ty, vy]))


def _command(tmp_path, monkeypatch, sub, *extra):
    monkeypatch.chdir(REPO)
    (tmp_path / sub).mkdir()
    argv = _argv(tmp_path / sub, "TPU.SWEEP_CACHE_DIR", "", *extra, device=("--device", "cpu"))
    argv[argv.index("--no-tuning") + 1] = "True"
    argv[argv.index("--device"):argv.index("--device")] = ["--lr", "0.01", "--l2", "0.001"]
    best, info = port_cli.main(argv)
    return best, info, _artifacts(tmp_path / sub)


def test_the_command_streams_a_host_split_as_the_preloaded_path_with_its_orders(
        tmp_path, monkeypatch):
    data = {}
    real_train_trials = TrainTask.train_trials

    def record(self, hparams, tx, ty, vx, vy, **kw):
        data.setdefault("types", []).append(type(tx))
        return real_train_trials(self, hparams, tx, ty, vx, vy, **kw)

    monkeypatch.setattr(TrainTask, "train_trials", record)
    best, info, (art, txt) = _command(tmp_path, monkeypatch, "streamed",
                                      "TPU.MAX_DEVICE_DATA_GB", str(STREAM))
    assert data["types"] == [np.ndarray]  # the merged train+val stayed on the host

    real_fit_eval_fn = TrainTask._fit_eval_fn

    def with_streamed_orders(self, n_train, n_epochs, n_val, trials=0):
        fe = real_fit_eval_fn(self, n_train, n_epochs, n_val, trials)
        orders = [ps.epoch_order(n_train, e) for e in range(n_epochs)]  # seed 0
        return lambda *a: fe(*a, orders=orders)

    monkeypatch.setattr(TrainTask, "_fit_eval_fn", with_streamed_orders)
    best2, info2, (art2, txt2) = _command(tmp_path, monkeypatch, "preloaded")
    assert data["types"] == [np.ndarray, torch.Tensor]
    assert best == best2 and txt == txt2
    assert json.dumps(art) == json.dumps(art2)
    np.testing.assert_array_equal(info["best_logits"], info2["best_logits"])
