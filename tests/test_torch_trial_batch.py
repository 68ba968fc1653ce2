"""A chunk of trials trained as one batch (``TrainTask.train_trials``) on
the tiny ViT of ``test_torch_trainer`` (width 128, 2 heads, 2 layers, 64 px,
patch 32, K = 4), fp32, 2 epochs of 20 images in batches of 8 (a natural
tail of 4), 70 val images (a chunk of 64 and a natural remainder of 6):

* batched against the port's serial path (``_train_trials_serial``, one
  trial after another), 3 trials with distinct (lr, wd), seeded non-zero
  PEFT factors, for KAdaptation (dropout 0 and 0.1), LoRA, the adapter,
  Compacter and the linear probe, and KAdaptation under Nesterov SGD with
  the gradient clip, TRAIN.TWO_LR and a weight-decay mask: every (trial,
  epoch) val logit and every trial's trained trainables within 1e-5 of
  their largest value;
* each optimiser's step of stacked trials, with (T,) lr and wd, a
  weight-decay mask, TWO_LR scales and the per-trial clip, equals each
  trial stepped alone on the same gradients (whole runs under Adam are
  not compared: its update divides by the gradient's own size, so the
  serial path alone moves by 2.4e-4 of a parameter between 1 and 8 CPU
  threads);
* batched against the reference's vmapped ``train_trials``, 3 trials,
  dropout 0, each trial's JAX orders injected, the Pallas kernels in
  interpret mode: KAdaptation on the NHWC (TPU.PARITY_FP32) and the
  pre-patchified path, and LoRA, at 1e-5;
* one launch per block per step per chunk: a run of 3 trials calls each
  kernel operator's plain version exactly as often as a run of 1;
* the raw-reshape scramble stays within a trial: permuting trial 1's rows
  leaves trial 0's logits as they were (KAdaptation and LoRA);
* ``last_trainable``, ``last_bundle`` and ``last_state`` are trial T-1's,
  equal to the serial path's, and round-trip through ``save_trainable`` /
  ``restore_trainable``;
* a streamed batched epoch equals the preloaded batched epoch handed its
  orders, bit for bit, the split crossing once an epoch for all trials;
* the kernel wrappers' shape rules at the trial-folded shapes.
"""

import jax
import numpy as np
import pytest
import torch

from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu.peft import PeftConfig
from pevit_tpu.train import trainer as jt
from pevit_tpu_torch import bridge
from pevit_tpu_torch.ckpt import restore_trainable, save_trainable
from pevit_tpu_torch.config import get_default_config
from pevit_tpu_torch.ops import attention as attn_ops
from pevit_tpu_torch.ops import fused_mlp as mlp_ops
from pevit_tpu_torch.ops._build import KernelInputError
from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig
from pevit_tpu_torch.train import (
    TaskStatic,
    TrainTask,
    make_optimizer,
    model_forward,
    partition,
    trainable_params,
    trainable_pred,
)
from pevit_tpu_torch.train.optim import clip_grad_norm
from pevit_tpu_torch.train import streaming as ps
from pevit_tpu_torch.train.partition import stack_trials

from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)
from .test_torch_trainer import (
    PORT_TINY,
    TINY,
    _cfg,
    _data,
    _flat,
    _jax_perms,
    _seed_peft,
    clip_params,  # noqa: F401  (fixture)
)

N_TRAIN, N_VAL, EPOCHS = 20, 70, 2
HPARAMS = [(0.01, 1e-3), (0.003, 1e-2), (0.02, 0.0)]
TOL = 1e-5
SEED = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's many small operators, restored
    afterwards: beside the suite's other workers on the same cores, a pool
    of threads per operator spins for each (about 30 s a case instead of
    under 1 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= TOL * scale, f"{what}: max err {err} > {TOL} * {scale}"


def _port_task(clip_params, method, *, dropout=0.0, parity=False, seeded=True, **train):
    """A port task on the bridged tiny tower whose trials draw seeded
    non-zero PEFT parameters from their own generators (after the init's
    draws), so that every trainable moves."""
    cfg = _cfg(get_default_config, parity=parity, **train)
    static = TaskStatic.from_config(cfg, PORT_TINY,
                                    PortPeftConfig(method=method, kadapt_dropout_p=dropout))
    clip = bridge.clip_from_jax(jax.tree.map(np.asarray, clip_params), PORT_TINY, device="cpu")
    task = TrainTask(cfg, static, clip, device="cpu")
    if seeded:
        init = task.init_bundle

        def init_bundle(gen):
            trainable, frozen, bn = init(gen)
            if trainable["peft"] is not None:
                with torch.no_grad():
                    for p in trainable["peft"].parameters():
                        if p.requires_grad:
                            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
            return trainable, frozen, bn

        task.init_bundle = init_bundle
    return task


def _spy_fit_eval(monkeypatch, task, seen: list):
    """Record each fit_eval call's (trained params, val logits)."""
    build = task._fit_eval_fn

    def wrapped(*a, **k):
        fit_eval = build(*a, **k)

        def run(*args, **kw):
            state, logits = fit_eval(*args, **kw)
            seen.append(({n: p.detach().clone() for n, p in state.params.items()},
                         logits.numpy()))
            return state, logits
        return run

    monkeypatch.setattr(task, "_fit_eval_fn", wrapped)


def _run(task, monkeypatch, serial: bool):
    """Per trial: (val logits (epochs, n_val, K), {name: trained param})."""
    images, labels = _data(N_TRAIN, seed=2)
    val, val_labels = _data(N_VAL, seed=3)
    seen = []
    _spy_fit_eval(monkeypatch, task, seen)
    train = task._train_trials_serial if serial else task.train_trials
    res = train(HPARAMS, images, labels, val, val_labels, end_epoch=EPOCHS, seed=SEED,
                keep_logits=True)
    if serial:
        return [(logits, params) for params, logits in seen], res
    ((params, logits),) = seen  # one batched call
    return [(logits[t], {n: p[t] for n, p in params.items()}) for t in range(len(HPARAMS))], res


BATCHED_CASES = [
    pytest.param("kadaptation", 0.0, {}, id="kadaptation"),
    pytest.param("kadaptation", 0.1, {}, id="kadaptation-dropout"),
    pytest.param("lora", 0.0, {}, id="lora"),
    pytest.param("adapter", 0.0, {}, id="adapter"),
    pytest.param("compacter", 0.0, {}, id="compacter"),
    pytest.param("linear_probe", 0.0, {}, id="linear_probe"),
    pytest.param("kadaptation", 0.0, {"NESTEROV": True, "CLIP_GRAD_NORM": 0.05,
                                      "TWO_LR": True, "WITHOUT_WD_LIST": ["bias"]},
                 id="kadaptation-nesterov-clip-twolr-wdmask"),
]


@pytest.mark.parametrize("method,dropout,train", BATCHED_CASES)
def test_batched_equals_serial(clip_params, monkeypatch, method, dropout, train):
    task = _port_task(clip_params, method, dropout=dropout, **train)
    assert task.batches_trials
    got, got_res = _run(task, monkeypatch, serial=False)
    task = _port_task(clip_params, method, dropout=dropout, **train)
    want, want_res = _run(task, monkeypatch, serial=True)
    assert len(got) == len(want) == len(HPARAMS)
    for t, ((g_logits, g_params), (w_logits, w_params)) in enumerate(zip(got, want)):
        assert g_logits.shape == (EPOCHS, N_VAL, 4)
        # training moved the logits by far more than the tolerance
        assert np.abs(w_logits[1] - w_logits[0]).max() > 100 * TOL * np.abs(w_logits).max()
        for e in range(EPOCHS):
            _close(g_logits[e], w_logits[e], f"trial {t} epoch {e} val logits")
        assert g_params.keys() == w_params.keys()
        for name in w_params:
            _close(g_params[name], w_params[name], f"trial {t} trained {name}")
        assert got_res[t]["best_score"] == pytest.approx(want_res[t]["best_score"], abs=1e-9)
    # the trials differ: each kept its own (lr, wd) and draws
    assert np.abs(got[0][0] - got[1][0]).max() > 1e-3


@pytest.mark.parametrize("name", ["sgd", "nesterov", "adam", "adamw", "rmsprop"])
def test_a_stacked_optimizer_step_equals_each_trials_own(name):
    T = 3
    gen = torch.Generator().manual_seed(0)
    shapes = {"peft.layers.0.q_left": (4, 2, 1), "head.linear.kernel": (6, 5),
              "head.linear.bias": (5,)}
    lr_scales = {n: 0.1 if n.startswith("peft") else 1.0 for n in shapes}
    wd_mask = {n: 0.0 if n.endswith("bias") else 1.0 for n in shapes}
    init, update = make_optimizer("sgd" if name == "nesterov" else name, momentum=0.9,
                                  nesterov=name == "nesterov", lr_scales=lr_scales,
                                  wd_mask=wd_mask)
    lrs, wds = [0.1, 0.03, 0.2], [1e-3, 1e-2, 0.0]
    stacked = {n: torch.randn((T,) + s, generator=gen) for n, s in shapes.items()}
    alone = [{n: p[t].clone() for n, p in stacked.items()} for t in range(T)]
    state, states = init(stacked), [init(a) for a in alone]
    for _ in range(3):
        grads = {n: torch.randn((T,) + s, generator=gen) for n, s in shapes.items()}
        state = update(clip_grad_norm(grads, 1.0, trials=T), stacked, state,
                       torch.tensor(lrs), torch.tensor(wds))
        for t in range(T):
            own = clip_grad_norm({n: g[t] for n, g in grads.items()}, 1.0)
            states[t] = update(own, alone[t], states[t], lrs[t], wds[t])
    for t in range(T):
        for n in shapes:
            torch.testing.assert_close(stacked[n][t], alone[t][n], rtol=1e-6, atol=1e-7)
            assert not torch.equal(stacked[n][t], stacked[n][(t + 1) % T])


@pytest.mark.parametrize("method,parity", [pytest.param("kadaptation", True, id="nhwc"),
                                           pytest.param("kadaptation", False, id="prepack"),
                                           pytest.param("lora", False, id="lora-prepack")])
def test_batched_equals_the_reference_vmapped_trials(clip_params, monkeypatch, method, parity):
    # LoRA's x32 delta makes fp32 training chaotic across the stacks
    # (test_torch_trainer's WHOLE_RUN_LR): on this split the port's serial
    # path parts from the reference's unbatched fit by 2.2e-5 of the largest
    # val logit within two epochs at lr 3e-4, as the batched path does from
    # the vmapped trials, and by 4e-6 at the rates below
    hparams = HPARAMS if method == "kadaptation" else [(lr * 0.01, wd) for lr, wd in HPARAMS]
    T = len(hparams)
    images, labels = _data(N_TRAIN, seed=4)
    val, val_labels = _data(N_VAL, seed=5)
    jcfg = _cfg(jax_defaults, parity=parity)
    jstatic = jt.TaskStatic.from_config(jcfg, TINY, PeftConfig(method=method, kadapt_dropout_p=0.0))
    jtask = jt.TrainTask(jcfg, jstatic, clip_params)
    real_init = jtask.init_bundle

    def jax_init(key):
        trainable, frozen, bn = real_init(key)
        _seed_peft(trainable["peft"]["layers"], method)
        return trainable, frozen, bn

    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), 17), T)
    inits = [jax_init(keys[t]) for t in range(T)]
    # each trial's epoch orders, from its state's key as the vmapped epoch draws them
    orders = [_jax_perms(jax.random.fold_in(keys[t], 23), N_TRAIN, EPOCHS) for t in range(T)]
    monkeypatch.setattr(jtask, "init_bundle", jax_init)
    jseen = []
    real_fe = jtask._fit_eval_fn

    def jax_fit_eval_fn(*a, **k):
        fe = real_fe(*a, **k)

        def run(*args):
            out = fe(*args)
            jseen.append(out)
            return out
        return run

    monkeypatch.setattr(jtask, "_fit_eval_fn", jax_fit_eval_fn)
    with jax.default_matmul_precision("highest"):
        jtask.train_trials(hparams, images, labels, val, val_labels, end_epoch=EPOCHS, seed=SEED)
    ((jstate, jlogits),) = jseen
    want_logits = np.asarray(jlogits)  # (T, E, n_val, K)

    ptask = _port_task(clip_params, method, parity=parity, seeded=False)

    def port_init(gen):
        t = (gen.initial_seed() - SEED * 1_000_003) // 2
        trainable, frozen, bn = inits[t]
        bundle, bn_t = bridge.from_jax(jax.tree.map(np.asarray, jt.combine(trainable, frozen)),
                                       jax.tree.map(np.asarray, bn), PORT_TINY,
                                       ptask.static.peft_cfg, device="cpu")
        bundle["clip"] = ptask.clip
        return (*partition(bundle, trainable_pred(ptask.static)), bn_t)

    monkeypatch.setattr(ptask, "init_bundle", port_init)
    pseen = []
    real_pfe = ptask._fit_eval_fn

    def port_fit_eval_fn(*a):
        fe = real_pfe(*a)

        def run(*args):
            out = fe(*args, orders=[np.stack([o[e] for o in orders]) for e in range(EPOCHS)])
            pseen.append(out)
            return out
        return run

    monkeypatch.setattr(ptask, "_fit_eval_fn", port_fit_eval_fn)
    ptask.train_trials(hparams, images, labels, val, val_labels, end_epoch=EPOCHS, seed=SEED)
    ((pstate, plogits),) = pseen
    assert plogits.shape == want_logits.shape == (T, EPOCHS, N_VAL, 4)
    # the second epoch moved the logits by far more than the tolerance
    assert np.abs(want_logits[:, 1] - want_logits[:, 0]).max() > 100 * TOL * np.abs(want_logits).max()
    for t in range(T):
        for e in range(EPOCHS):
            _close(plogits[t, e].numpy(), want_logits[t, e], f"trial {t} epoch {e} val logits")
    for t in range(T):
        got = _flat(bridge._tree_to_jax({n: p.detach()[t] for n, p in pstate.params.items()}))
        want = _flat(jax.tree.map(lambda a: np.asarray(a)[t], jstate[0]))
        assert got.keys() == want.keys()
        for name in want:
            _close(got[name], want[name], f"trial {t} trained {name}")


@pytest.mark.parametrize("method", ["kadaptation", "lora"])
def test_one_launch_per_block_per_step_per_chunk(clip_params, monkeypatch, method):
    calls = {"attention": 0, "fwd": 0, "bwd": 0}

    def counting(key, fn):
        def count(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return count

    monkeypatch.setattr(attn_ops, "attention_ref", counting("attention", attn_ops.attention_ref))
    monkeypatch.setattr(mlp_ops, "fused_mlp_residual_ref",
                        counting("fwd", mlp_ops.fused_mlp_residual_ref))
    monkeypatch.setattr(mlp_ops, "fused_mlp_bwd_ref", counting("bwd", mlp_ops.fused_mlp_bwd_ref))
    images, labels = _data(N_TRAIN, seed=6)
    val, val_labels = _data(N_VAL, seed=7)
    counts = []
    for hparams in (HPARAMS[:1], HPARAMS):
        task = _port_task(clip_params, method)
        for key in calls:
            calls[key] = 0
        task.train_trials(hparams, images, labels, val, val_labels, end_epoch=EPOCHS)
        counts.append(dict(calls))
    steps, chunks = EPOCHS * 3, EPOCHS * 2  # 8 + 8 + 4 images; 64 + 6
    layers = PORT_TINY.vision.layers
    want = {"attention": layers * (steps + chunks), "fwd": layers * (steps + chunks),
            "bwd": layers * steps}
    assert counts == [want, want]


@pytest.mark.parametrize("method", ["kadaptation", "lora"])
def test_the_scramble_stays_within_a_trial(clip_params, method):
    """Two trials' batches folded into one forward: permuting trial 1's rows
    leaves trial 0's logits bit for bit, while trial 1's move (the scramble
    mixes a trial's rows, so a fold over both trials' rows would move trial
    0's too)."""
    task = _port_task(clip_params, method)
    bundles, bns = [], []
    for t in range(2):
        trainable, frozen, bn = task.init_bundle(torch.Generator().manual_seed(t))
        bundles.append({"clip": task.clip, "peft": trainable["peft"], "head": trainable["head"]})
        bns.append(bn)
    bundle = stack_trials(bundles)
    bn = {k: torch.stack([b[k] for b in bns]) for k in bns[0]}
    images, _ = _data(16, seed=8)
    x = task.prepack(images)

    def logits(x):
        with torch.no_grad():
            return model_forward(task.static, bundle, bn, x, task.preproc, train=False,
                                 trials=2)[0]

    before = logits(x)
    perm = torch.cat([torch.arange(8), 8 + torch.randperm(8, generator=torch.Generator().manual_seed(0))])
    after = logits(x[perm])
    assert torch.equal(after[0], before[0])
    moved = (after[1] - before[1][perm[8:] - 8]).abs().max()
    assert moved > 1e-3 * before[1].abs().max()


def test_last_trial_is_kept_and_round_trips(clip_params, monkeypatch, tmp_path):
    images, labels = _data(N_TRAIN, seed=9)
    val, val_labels = _data(N_VAL, seed=10)
    kept = {}
    for name, serial in (("batched", False), ("serial", True)):
        task = _port_task(clip_params, "kadaptation")
        train = task._train_trials_serial if serial else task.train_trials
        train(HPARAMS, images, labels, val, val_labels, end_epoch=EPOCHS, seed=SEED)
        kept[name] = task
    got, want = kept["batched"], kept["serial"]
    g_params, w_params = trainable_params(got.last_trainable), trainable_params(want.last_trainable)
    assert g_params.keys() == w_params.keys()
    for n in w_params:
        assert g_params[n].shape == w_params[n].shape
        _close(g_params[n].detach().numpy(), w_params[n].detach().numpy(), f"last trainable {n}")
    # last_bundle holds the same parameters as last_trainable; last_state too
    bundle_params = trainable_params(partition(got.last_bundle, trainable_pred(got.static))[0])
    assert all(bundle_params[n] is p for n, p in g_params.items())
    assert all(got.last_state.params[n] is p for n, p in g_params.items())
    for k in ("mean", "var"):
        _close(got.last_state.bn[k].numpy(), want.last_state.bn[k].numpy(), f"last bn {k}")
    for n, buf in want.last_state.opt.momentum_buf.items():
        _close(got.last_state.opt.momentum_buf[n].numpy(), buf.numpy(), f"momentum {n}")
    _close(got.last_state.loss.item(), want.last_state.loss.item(), "last loss")
    assert got.last_state.generator.initial_seed() == SEED * 1_000_003 + 2 * (len(HPARAMS) - 1) + 1
    info = got.model_info(got.last_trainable)
    assert info == want.model_info(want.last_trainable)
    save_trainable(str(tmp_path), got.last_bundle, step=EPOCHS)
    restored = restore_trainable(str(tmp_path), got.last_bundle)
    assert restored.keys() == g_params.keys()
    assert all(torch.equal(restored[n], g_params[n].detach()) for n in g_params)
    score, _ = got.evaluate(got.last_trainable, partition(got.last_bundle,
                                                          trainable_pred(got.static))[1],
                            got.last_state.bn, val, val_labels)
    assert 0.0 <= score <= 100.0


def test_a_streamed_batched_epoch_equals_the_preloaded_one(clip_params):
    images, labels = _data(N_TRAIN + 1, seed=11)  # 8 + 8 + a tail of 5
    val, val_labels = _data(N_VAL, seed=12)
    task = _port_task(clip_params, "kadaptation", dropout=0.1)
    task.config.defrost()
    task.config.TPU.MAX_DEVICE_DATA_GB = 1e-9
    task.config.freeze()
    runners, init = [], ps.StreamingEpochRunner.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        runners.append(self)

    seen = []
    ps.StreamingEpochRunner.__init__ = spy
    real = task._evaluate_trials
    task._evaluate_trials = lambda *a: (lambda out: (seen.append(out), out)[1])(real(*a))
    try:
        task.train_trials(HPARAMS, images, labels, val, val_labels, end_epoch=EPOCHS, seed=SEED)
    finally:
        ps.StreamingEpochRunner.__init__ = init
    (runner,) = runners
    assert runner.trials == len(HPARAMS)
    assert runner.batches == 3 * EPOCHS and runner.h2d_bytes == EPOCHS * images.nbytes
    streamed_last = {n: p.detach().clone() for n, p in trainable_params(task.last_trainable).items()}

    twin = _port_task(clip_params, "kadaptation", dropout=0.1)
    fit_eval = twin._fit_eval_fn(len(labels), EPOCHS, N_VAL, len(HPARAMS))
    batch = twin._init_trials(SEED, len(HPARAMS))
    orders = [ps.epoch_order(len(labels), SEED * 1000 + e) for e in range(EPOCHS)]
    _, logits = fit_eval(batch.bundle, twin.prepack(images), twin._labels(labels),
                         twin.prepack(val), batch.state, [[lr] * EPOCHS for lr, _ in HPARAMS],
                         [wd for _, wd in HPARAMS], orders=orders)
    for e in range(EPOCHS):
        for t in range(len(HPARAMS)):
            z = logits[t, e].numpy()
            z = z - z.max(-1, keepdims=True)
            np.testing.assert_array_equal(seen[e][t][1], np.exp(z) / np.exp(z).sum(-1, keepdims=True))
    twin_last = trainable_params(batch.trees[-1][0])
    for n, p in streamed_last.items():
        assert torch.equal(p, twin_last[n].detach())


def test_kernel_wrappers_take_the_trial_folded_shapes():
    """The largest shapes a shipped YAML gives the kernels with
    TPU.SWEEP_PARALLEL_TRIALS up to 16 pass the wrappers' shape rules: a
    train step of 16 trials x 128 images and an eval chunk of 16 x 512 on
    ViT-L/14 (N = 257, F = 4096), and at 336 px (N = 577); R x F passes
    2^31 there, which the kernels index in 64 bits.  Beyond the grid's
    limits the wrappers raise KernelInputError before any launch."""
    tokens, heads, hidden = 257, 16, 4096  # vitl14_CLIP.yaml
    for images in (16 * 128, 16 * 512):
        mlp_ops.check_rows("fused_mlp_fwd", images * tokens)
        for dtype in (torch.float32, torch.bfloat16):
            for n in (tokens, 577):
                attn_ops.check_grid(images, heads, n, dtype)
    assert 16 * 512 * tokens * hidden > 2 ** 31
    mlp_ops.check_rows("fused_mlp_bwd", mlp_ops.MAX_ROWS)
    with pytest.raises(KernelInputError, match="rows"):
        mlp_ops.check_rows("fused_mlp_bwd", mlp_ops.MAX_ROWS + 1)
    # fp32 takes a block per 64 queries: 5 for N = 257; bf16 one per head
    # up to N = 257 and a block per 64 queries beyond: 10 for N = 577
    B = attn_ops.MAX_BLOCKS // (heads * 5) + 1
    attn_ops.check_grid(B, heads, tokens, torch.bfloat16)
    with pytest.raises(KernelInputError, match="blocks"):
        attn_ops.check_grid(B, heads, tokens, torch.float32)
    B = attn_ops.MAX_BLOCKS // (heads * 10)
    for dtype in (torch.float32, torch.bfloat16):
        attn_ops.check_grid(B, heads, 577, dtype)
        with pytest.raises(KernelInputError, match="blocks"):
            attn_ops.check_grid(B + 1, heads, 577, dtype)
