"""The port's mesh (``parallel``, ``utils.dist``) in gloo worlds on the CPU,
held to the JAX package on its 8 virtual CPU devices.

The pytest process runs the reference (``pevit_tpu.train.TrainTask`` with
the same knobs, on a mesh of its 8 devices) on the tiny ViT of
``test_torch_trainer`` (width 128, 2 heads, 2 layers, 64 px, patch 32,
K = 4, float32), writes its inputs as numpy, then launches worlds of the
port's processes (this file run as a script, one process a rank, the
launcher's variables set as ``torchrun`` sets them) that import no JAX,
and compares what they write:

* the plan tuples of ``TrainTask._mesh_plan`` for the knob cases of
  ``tests/test_sharding.py``, against the reference's on 8 devices;
* a chunk of 8 KAdaptation trials over 2 trial ranks (4 + 4) against the
  reference's vmapped trials over its trial axis: val logits and scores
  at 1e-5, trained parameters at 1e-5 of each leaf's largest value; every
  rank returns every result and holds trial 7 as its last;
* the final run over 2 data ranks, n_train 44 and n_val 17 in batches and
  eval chunks of 16 (8 rows a rank; a natural tail of 12 and a remainder
  of 1 run whole), KAdaptation under ``reference_compat`` with seeded
  factors so that the raw-reshape scramble (quirk 4) mixes rows across
  ranks: trained parameters within 1e-6, val logits within 1e-5 of the
  reference's data-parallel run; a control that takes the delta from a
  rank's own rows fails; the same run streamed from host memory (each data
  rank gathering its rows of a batch) equals the port's streamed run
  without a world (parameters within 1e-6, probabilities within 1e-5);
* tensor parallelism, (data 2, model 2) in a world of 4, LoRA in the
  reference's ``test_mesh_model_tensor_parallel_matches`` setting, rtol
  1e-5 and atol 2e-6: held to the port's single-process run at that
  setting's rate (1e-2), and to the reference's tensor-parallel run at
  1e-3.  At 1e-2 LoRA's float32 training is chaotic between the packages
  (``test_torch_trainer``'s ``WHOLE_RUN_LR``): the port's single-process
  run itself parts from the reference's by 4.3e-6 over that tolerance,
  the tensor-parallel run from the single-process one by none;
* mesh serving, width 2: a baked fp artifact and an int8 weights-as-args
  one at batches 8 and 16 equal the single-process serving function (the
  scramble live), a batch of 7 refused;
* ``gathered_contrastive_logits`` and its gradients against the
  reference's ``shard_map`` version on 2 devices, at 1e-5;
* a sweep chunk that runs out of memory on one rank only is halved on
  every rank, and the ranks' scores agree;
* the LR rule (TRAIN.LR times the hosts, ``WORLD_SIZE /
  LOCAL_WORLD_SIZE``): unchanged by 2 ranks on one host, doubled by 4
  ranks at 2 a host; the collectives of ``utils.dist``;
* a world of one is bit for bit the run without a process group.

A world costs a Python start and a ``torch`` import a rank, so each runs
several checks; every process runs one intra-op thread.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
SEED = 0
EPOCHS = 2
K = 4
RES = 64
TRIAL_HPARAMS = [(10 ** e, 10 ** w) for e, w in
                 [(-2, -4), (-3, -2), (-2, -5), (-2, -2), (-4, -3), (-3, -4), (-2, -3), (-3, -5)]]
TINY_SPEC = dict(embed_dim=32,
                 vision=dict(input_resolution=RES, patch_size=32, width=128, layers=2, heads=2,
                             output_dim=32),
                 text=dict(context_length=8, vocab_size=64, width=32, heads=2, layers=1,
                           output_dim=32))


# ---------------------------------------------------------------------------
# The port's side: a rank of a world (this file run as a script; no JAX)
# ---------------------------------------------------------------------------

def _port_spec():
    from pevit_tpu_torch.core import clip as pc

    return pc.CLIPSpec(embed_dim=TINY_SPEC["embed_dim"],
                       vision=pc.VisionSpec(**TINY_SPEC["vision"]),
                       text=pc.TextSpec(**TINY_SPEC["text"]))


def _port_task(case: dict, run: dict):
    """A port task on the reference's tower whose trial t starts from the
    reference's trial-t parameters and takes the reference's epoch orders."""
    import torch

    from pevit_tpu_torch import bridge
    from pevit_tpu_torch.config import get_default_config
    from pevit_tpu_torch.peft.base import PeftConfig
    from pevit_tpu_torch.train import TaskStatic, TrainTask
    from pevit_tpu_torch.train.partition import partition
    from pevit_tpu_torch.train.trainer import trainable_pred

    cfg = get_default_config()
    cfg.defrost()
    cfg.TEST.METRIC = ""
    cfg.DATASET.NUM_CLASSES = K
    cfg.TRAIN.BATCH_SIZE_PER_GPU = run["batch"]
    cfg.TPU.PARITY_FP32 = run.get("parity", False)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    for k, v in run.get("tpu", {}).items():
        cfg.TPU[k] = v
    cfg.freeze()
    spec = _port_spec()
    peft_cfg = PeftConfig(method=run["method"], kadapt_dropout_p=0.0)
    static = TaskStatic.from_config(cfg, spec, peft_cfg)
    clip = bridge.clip_from_jax(case["clip"], spec, device="cpu")
    task = TrainTask(cfg, static, clip, device="cpu", eval_chunk=run["eval_chunk"])
    inits = run["inits"]

    def init_bundle(gen, tower=None):
        t = (gen.initial_seed() - SEED * 1_000_003) // 2
        bundle_np, bn_np = inits[t]
        bundle, bn = bridge.from_jax(bundle_np, bn_np, spec, peft_cfg, device="cpu")
        bundle["clip"] = task.clip
        return (*partition(bundle, trainable_pred(static)), bn)

    task.init_bundle = init_bundle
    seen = []
    build = task._fit_eval_fn

    def fit_eval_fn(n_train, n_epochs, n_val, trials=0, mesh=None):
        fe = build(n_train, n_epochs, n_val, trials, mesh)
        first = 0 if mesh is None else mesh.trial.index * trials
        orders = [np.stack([run["orders"][first + t][e] for t in range(trials)])
                  for e in range(n_epochs)]

        def go(*args):
            state, logits = fe(*args, orders=orders)
            seen.append((first, {n: p.detach().clone().numpy() for n, p in state.params.items()},
                         logits.numpy()))
            return state, logits
        return go

    task._fit_eval_fn = fit_eval_fn
    torch.manual_seed(0)
    return task, seen


def _train(case: dict, name: str) -> dict:
    run = case[name]
    task, seen = _port_task(case, run)
    res = task.train_trials(run["hparams"], run["train"][0], run["train"][1], run["val"][0],
                            run["val"][1], end_epoch=EPOCHS, seed=SEED, keep_logits=True)
    plan = task._mesh_plan(len(run["hparams"]))
    mesh = plan[0]
    last = {n: p.detach().clone().numpy() for n, p in task.last_state.params.items()}
    return {"seen": seen, "scores": [r["best_score"] for r in res],
            "best_logits": [r["best_logits"] for r in res], "last": last,
            "plan": (plan[1], plan[2], 1 if mesh is None else mesh.shape[2]), "task": task}


def _check_dist(case: dict) -> dict:
    import argparse

    from pevit_tpu_torch.config import get_default_config
    from pevit_tpu_torch.config.defaults import update_config
    from pevit_tpu_torch.utils import dist as comm

    cfg = get_default_config()
    update_config(cfg, argparse.Namespace(cfg=case["yaml"], opts=[]))  # TRAIN.LR 0.25
    return {"rank": comm.rank(), "world": comm.world_size(), "local": comm.local_rank(),
            "main": comm.is_main_process(), "hosts": comm.host_count(),
            "lr_factor": cfg.TRAIN.LR / 0.25,
            "reduced": comm.reduce_dict({"a": comm.rank() + 1.0, "b": 2.0}),
            "gathered": comm.all_gather_object(("r", comm.rank())),
            "max": comm.max_over_world(10 * comm.rank())}


def _check_trials(case: dict) -> dict:
    out = _train(case, "trials")
    out.pop("task")
    return out


def _check_final_dp(case: dict) -> dict:
    out = _train(case, "final_dp")
    task = out.pop("task")
    # the control: each rank's delta from its own rows only
    from pevit_tpu_torch.parallel import mesh as pmesh

    real = pmesh.RowShard.hooks
    pmesh.RowShard.hooks = lambda self, hooks, trials: hooks
    try:
        control = _train(case, "final_dp")
        control.pop("task")
    finally:
        pmesh.RowShard.hooks = real
    out["control"] = control["seen"]
    streamed = _train(case, "final_stream")
    streamed.pop("task")
    out["streamed"] = streamed
    out["serve"] = _check_serve(task)
    return out


def _check_serve(task) -> dict:
    """Mesh serving of the final run's trained classifier, width = world."""
    import torch

    from pevit_tpu_torch.serve import (
        export_classifier,
        exported_callable,
        exported_data_width,
        make_serving_fn,
        serving_weights,
    )
    from pevit_tpu_torch.utils import dist as comm

    from pevit_tpu_torch.train.partition import partition
    from pevit_tpu_torch.train.trainer import trainable_pred

    n = comm.world_size()
    trainable, frozen = partition(task.last_bundle, trainable_pred(task.static))
    bn = task.last_state.bn
    rng = np.random.default_rng(11)
    out = {"width": [], "err": {}, "refused": False}
    for quantize, bake in ((False, True), (True, False)):
        ep = export_classifier(task.static, trainable, frozen, bn, task.preproc,
                               image_size=RES, device="cpu", mesh=n, quantize=quantize,
                               bake_weights=bake)
        out["width"].append(exported_data_width(ep))
        weights = None if bake else serving_weights(trainable, frozen, bn, quantize=quantize)
        call = exported_callable(ep, weights, device="cpu")
        serve = make_serving_fn(task.static, trainable, frozen, bn, task.preproc,
                                quantize=quantize, device="cpu")
        for batch in (8, 16):
            x = rng.integers(0, 256, (batch, RES, RES, 3), dtype=np.uint8)
            got, want = call(x), serve(x)
            alone = torch.cat([serve(x[i:i + batch // n]) for i in range(0, batch, batch // n)])
            out["err"][(quantize, batch)] = (
                float((got - want).abs().max()), float(want.abs().max()),
                float((alone - want).abs().max()))
        try:
            call(rng.integers(0, 256, (7, RES, RES, 3), dtype=np.uint8))
        except ValueError as e:
            out["refused"] = "multiples of" in str(e)
    return out


def _check_tp(case: dict) -> dict:
    out = _train(case, "tp")
    out.pop("task")
    fast = _train(case, "tp_fast")
    fast.pop("task")
    out["fast"] = fast
    return out


def _check_declip(case: dict) -> dict:
    import torch

    from pevit_tpu_torch.models import gathered_contrastive_logits
    from pevit_tpu_torch.utils import dist as comm

    d = case["declip"]
    r = comm.rank()
    img = torch.tensor(d["images"][r], requires_grad=True)
    txt = torch.tensor(d["texts"][r], requires_grad=True)
    scale = torch.tensor(d["scale"], requires_grad=True)
    logits = gathered_contrastive_logits(img, txt, scale)
    (logits * torch.tensor(d["weights"][r])).sum().backward()
    return {"logits": logits.detach().numpy(), "d_img": img.grad.numpy(),
            "d_txt": txt.grad.numpy(), "d_scale": float(scale.grad)}


def _check_oom(case: dict) -> dict:
    """A chunk of 4 trials over 2 trial ranks, rank 1 out of memory while
    its part holds more than one trial: both ranks must halve."""
    import torch

    from pevit_tpu_torch.train import sweep
    from pevit_tpu_torch.utils import dist as comm

    run = case["trials"]
    task, _ = _port_task(case, run)
    real = task._train_batch
    widths = []

    def train_batch(batch, hparams, *a, **k):
        widths.append(len(hparams))
        if comm.rank() == 1 and len(hparams) > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real(batch, hparams, *a, **k)

    task._train_batch = train_batch
    chunks = []
    real_chunk = sweep._run_chunk

    def run_chunk(task_, chunk, *a, **k):
        chunks.append(len(chunk))
        return real_chunk(task_, chunk, *a, **k)

    sweep._run_chunk = run_chunk
    try:
        data = (run["train"][0], run["train"][1], run["val"][0], run["val"][1])
        scores = sweep._run_stage(task, run["hparams"][:4], data, 1, SEED, 4)
    finally:
        sweep._run_chunk = real_chunk
    return {"chunks": chunks, "widths": widths, "scores": scores}


def _check_world_one(case: dict) -> dict:
    """The same chunk before and after joining a world of one."""
    from pevit_tpu_torch.utils import dist as comm

    before = _train(case, "trials_small")
    before.pop("task")
    comm.initialize(device="cpu")
    assert comm.world_size() == 1 and comm.is_initialized()
    after = _train(case, "trials_small")
    after.pop("task")
    return {"before": before, "after": after}


CHECKS = {"dist": _check_dist, "trials": _check_trials, "final_dp": _check_final_dp,
          "tp": _check_tp, "declip": _check_declip, "oom": _check_oom,
          "world_one": _check_world_one}


def worker_main(case_path: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from pevit_tpu_torch.utils import dist as comm

    with open(case_path, "rb") as f:
        case = pickle.load(f)
    if case["checks"] != ["world_one"]:
        comm.initialize(device="cpu")
    out = {name: CHECKS[name](case) for name in case["checks"]}
    rank = int(os.environ["RANK"])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if comm.is_initialized():
        comm.barrier()
        import torch.distributed as dist

        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The pytest side: the reference, the worlds, the comparisons
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_world(case: dict, tmp: Path, world: int, local_world: int = 0):
    """Start this file's worker in ``world`` processes (the launcher's
    variables as torchrun sets them); returns a function that waits for them
    and gives each rank's results."""
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    port = _free_port()
    local_world = local_world or world
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank % local_world),
                   LOCAL_WORLD_SIZE=str(local_world), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen([sys.executable, __file__, str(tmp / "case.pkl"), str(tmp)],
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))

    def results() -> list:
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for rank, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {rank} failed:\n{out[-6000:]}"
        got = []
        for rank in range(world):
            with open(tmp / f"rank{rank}.pkl", "rb") as f:
                got.append(pickle.load(f))
        return got

    return results


def _jax_side():
    """The reference's modules, imported in the pytest process only."""
    import jax

    from pevit_tpu.config import get_default_config as jax_defaults
    from pevit_tpu.core import CLIPSpec, TextSpec, VisionSpec, init_clip_params
    from pevit_tpu.peft import PeftConfig
    from pevit_tpu.train import trainer as jt

    spec = CLIPSpec(embed_dim=TINY_SPEC["embed_dim"], vision=VisionSpec(**TINY_SPEC["vision"]),
                    text=TextSpec(**TINY_SPEC["text"]))
    return jax, jax_defaults, spec, init_clip_params, PeftConfig, jt


def _jax_cfg(jax_defaults, batch: int, parity: bool, tpu: dict):
    cfg = jax_defaults()
    cfg.defrost()
    cfg.TEST.METRIC = ""
    cfg.DATASET.NUM_CLASSES = K
    cfg.TRAIN.BATCH_SIZE_PER_GPU = batch
    cfg.TPU.PARITY_FP32 = parity
    cfg.TPU.COMPUTE_DTYPE = "float32"
    for k, v in tpu.items():
        cfg.TPU[k] = v
    cfg.freeze()
    return cfg


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, RES, RES, 3), dtype=np.uint8),
            rng.integers(0, K, (n,)).astype(np.int32))


def _reference_run(clip_params, *, method, hparams, n_train, n_val, batch, eval_chunk,
                   tpu, seeded, parity=False, data_seed=0):
    """The reference's train_trials with ``tpu`` knobs on its 8 devices:
    (what a port world needs to replay it, a function that trains it and
    gives what it gave)."""
    from .test_torch_trainer import _jax_perms, _seed_peft

    jax, jax_defaults, spec, _, PeftConfig, jt = _jax_side()
    jcfg = _jax_cfg(jax_defaults, batch, parity, tpu)
    jstatic = jt.TaskStatic.from_config(jcfg, spec, PeftConfig(method=method, kadapt_dropout_p=0.0))
    jtask = jt.TrainTask(jcfg, jstatic, clip_params, eval_chunk=eval_chunk)
    real_init = jtask.init_bundle

    def jax_init(key):
        trainable, frozen, bn = real_init(key)
        if seeded:
            _seed_peft(trainable["peft"]["layers"], method)
        return trainable, frozen, bn

    T = len(hparams)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), 17), T)
    inits = [jax_init(keys[t]) for t in range(T)]
    orders = [_jax_perms(jax.random.fold_in(keys[t], 23), n_train, EPOCHS) for t in range(T)]
    jtask.init_bundle = jax_init
    seen = []
    real_fe = jtask._fit_eval_fn

    def fit_eval_fn(*a, **k):
        fe = real_fe(*a, **k)

        def go(*args):
            out = fe(*args)
            seen.append(out)
            return out
        return go

    jtask._fit_eval_fn = fit_eval_fn
    train, val = _data(n_train, data_seed), _data(n_val, data_seed + 1)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    port = {"method": method, "hparams": hparams, "batch": batch, "eval_chunk": eval_chunk,
            "tpu": tpu, "parity": parity, "train": train, "val": val, "orders": orders,
            "inits": [(to_np(jt.combine(tr, fr)), to_np(bn)) for tr, fr, bn in inits]}

    def run() -> dict:
        with jax.default_matmul_precision("highest"):
            res = jtask.train_trials(hparams, *train, *val, end_epoch=EPOCHS, seed=SEED,
                                     keep_logits=True)
        plan = jtask._mesh_plan(T)
        ((jstate, jlogits),) = seen
        return {"port": port, "logits": np.asarray(jlogits), "params": to_np(jstate[0]),
                "scores": [r["best_score"] for r in res],
                "plan": (plan[1], plan[2],
                         plan[0].shape.get("model", 1) if plan[0] is not None else 1)}

    return port, run


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


def _port_params_as_jax(params: dict, t: int) -> dict:
    """Trial t of a port run's stacked trained parameters, in the reference's
    flat names."""
    import torch

    from pevit_tpu_torch import bridge

    return _flat(bridge._tree_to_jax({n: torch.as_tensor(p[t]) for n, p in params.items()}))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference run, and the worlds of 2, 4 and 1 ranks that replay
    them."""
    jax, _, spec, init_clip_params, _, _ = _jax_side()
    from pevit_tpu.core import layers as jax_layers

    prev = jax_layers._ATTN_LAYOUT
    jax_layers.set_attn_layout("bnhd")
    try:
        clip_params = init_clip_params(jax.random.PRNGKey(0), spec)
        ports, train = {}, {}
        for name, kw in {
            "trials": dict(method="kadaptation", hparams=TRIAL_HPARAMS, n_train=20, n_val=70,
                           batch=8, eval_chunk=64, tpu={"SWEEP_TRIALS_OVER_MESH": True},
                           seeded=True),
            "final_dp": dict(method="kadaptation", hparams=[(1e-2, 1e-4)], n_train=44, n_val=17,
                             batch=16, eval_chunk=16, tpu={"MESH_DATA": -1}, seeded=True,
                             data_seed=5),
            "tp": dict(method="lora", hparams=[(1e-3, 1e-4)], n_train=32, n_val=16, batch=16,
                       eval_chunk=16, tpu={"MESH_MODEL": 2, "MESH_DATA": -1}, seeded=False,
                       data_seed=9),
        }.items():
            ports[name], train[name] = _reference_run(clip_params, **kw)
        declip = _declip_reference(jax)
        clip_np = jax.tree.map(np.asarray, clip_params)
        tmp = tmp_path_factory.mktemp("worlds")
        yaml = tmp / "lr.yaml"
        yaml.write_text("TRAIN:\n  LR: 0.25\n")
        base = {"clip": clip_np, "yaml": str(yaml), "declip": declip["inputs"]}
        small = dict(ports["trials"], hparams=TRIAL_HPARAMS[:2])
        # the reference test's own rate, for the port's tensor-parallel run
        # against its single-process run (here, no world)
        tp_fast = dict(ports["tp"], hparams=[(1e-2, 1e-4)])
        # the final run streamed from host memory, in a world and without one
        final_stream = dict(ports["final_dp"],
                            tpu={**ports["final_dp"]["tpu"], "MAX_DEVICE_DATA_GB": 1e-9})
        # the worlds run while this process trains the reference
        pending = {
            2: launch_world(dict(base, trials=ports["trials"], final_dp=ports["final_dp"],
                                 final_stream=final_stream,
                                 checks=["dist", "trials", "final_dp", "declip", "oom"]),
                            tmp / "w2", 2),
            4: launch_world(dict(base, tp=ports["tp"], tp_fast=tp_fast, checks=["dist", "tp"]),
                            tmp / "w4", 4, local_world=2),
            1: launch_world(dict(base, trials_small=small, checks=["world_one"]), tmp / "w1", 1),
        }
        runs = {name: run() for name, run in train.items()}
        runs["declip"] = declip
    finally:
        jax_layers.set_attn_layout(prev)
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside the suite's other workers, as the worlds' ranks
    try:
        for name, port in (("final_stream_single", final_stream),
                           ("tp_fast_single", dict(tp_fast, tpu={}))):
            runs[name] = _train({"clip": clip_np, "x": port}, "x")
            runs[name].pop("task")
    finally:
        torch.set_num_threads(threads)
    worlds = {world: results() for world, results in pending.items()}
    return runs, worlds


def _declip_reference(jax) -> dict:
    """The reference's gathered logits under ``shard_map`` on 2 devices,
    each holding 3 images and 3 texts, and the gradients of a weighted sum."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from pevit_tpu.models.declip import gathered_contrastive_logits

    rng = np.random.default_rng(21)
    images = rng.standard_normal((2, 3, 8)).astype(np.float32)
    texts = rng.standard_normal((2, 3, 8)).astype(np.float32)
    weights = rng.standard_normal((2, 3, 6)).astype(np.float32)
    scale = np.float32(0.7)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    fn = jax.shard_map(lambda i, t, s: gathered_contrastive_logits(i, t, s[0], "data"),
                       mesh=mesh, in_specs=(P("data"), P("data"), P()), out_specs=P("data"),
                       check_vma=False)

    def loss(i, t, s):
        return jnp.sum(fn(i, t, s) * weights.reshape(6, 6))

    args = (images.reshape(6, 8), texts.reshape(6, 8), np.asarray([scale]))
    with jax.default_matmul_precision("highest"):
        logits = np.asarray(fn(*args))
        gi, gt, gs = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return {"inputs": {"images": images, "texts": texts, "weights": weights, "scale": scale},
            "logits": logits.reshape(2, 3, 6), "d_img": np.asarray(gi).reshape(2, 3, 8),
            "d_txt": np.asarray(gt).reshape(2, 3, 8), "d_scale": float(np.asarray(gs)[0])}


# -- plans (in this process: the plan is arithmetic on the world's size) ------

PLAN_CASES = [  # (knobs, trials), the cases of tests/test_sharding.py
    pytest.param({"MESH_DATA": -1}, 1, id="final-run-data-parallel"),
    pytest.param({"MESH_DATA": 1}, 1, id="final-run-data-off"),
    pytest.param({"MESH_MODEL": 2, "MESH_DATA": -1}, 1, id="tensor-parallel"),
    pytest.param({"MESH_MODEL": 1, "MESH_DATA": 1}, 1, id="tensor-parallel-off"),
    pytest.param({"SWEEP_TRIALS_OVER_MESH": True}, 8, id="trials-over-mesh"),
    pytest.param({"SWEEP_TRIALS_OVER_MESH": False}, 8, id="trials-not-over-mesh"),
    pytest.param({}, 2, id="two-trials-on-a-data-mesh"),
]


@pytest.mark.parametrize("knobs,trials", PLAN_CASES)
def test_mesh_plan_equals_the_references(monkeypatch, knobs, trials):
    jax, jax_defaults, spec, init_clip_params, PeftConfig, jt = _jax_side()
    from pevit_tpu_torch.config import get_default_config
    from pevit_tpu_torch.parallel import mesh as pmesh
    from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig
    from pevit_tpu_torch.train import TaskStatic, TrainTask
    from pevit_tpu_torch.utils import dist as comm

    assert len(jax.devices()) == 8
    batch = 16
    jcfg = _jax_cfg(jax_defaults, batch, False, knobs)
    jstatic = jt.TaskStatic.from_config(jcfg, spec, PeftConfig(method="lora"))
    jtask = jt.TrainTask(jcfg, jstatic, init_clip_params(jax.random.PRNGKey(0), spec))
    mesh, n_t, n_d = jtask._mesh_plan(trials)
    want = (n_t, n_d, 1 if mesh is None else mesh.shape.get("model", 1))

    monkeypatch.setattr(comm, "world_size", lambda: 8)
    monkeypatch.setattr(pmesh, "make_mesh",
                        lambda n_data, n_model, n_trial: (n_trial, n_data, n_model))
    cfg = get_default_config()
    cfg.defrost()
    cfg.TRAIN.BATCH_SIZE_PER_GPU = batch
    for k, v in knobs.items():
        cfg.TPU[k] = v
    cfg.freeze()
    port_spec = _port_spec()
    from pevit_tpu_torch.core.clip import init_clip_params as port_init

    import torch

    task = TrainTask(cfg, TaskStatic.from_config(cfg, port_spec, PortPeftConfig(method="lora")),
                     port_init(torch.Generator().manual_seed(0), port_spec, device="cpu"),
                     device="cpu")
    got_mesh, got_t, got_d = task._mesh_plan(trials)
    got = (got_t, got_d, 1 if got_mesh is None else got_mesh[2])
    assert got == want
    assert (got_mesh is None) == (mesh is None)
    assert task.max_parallel_trials() == jtask.max_parallel_trials()


# -- the worlds ---------------------------------------------------------------

def test_dist_identity_collectives_and_the_lr_rule(reference):
    _, worlds = reference
    for world, ranks in ((2, worlds[2]), (4, worlds[4])):
        for r, out in enumerate(ranks):
            d = out["dist"]
            assert (d["rank"], d["world"], d["main"]) == (r, world, r == 0)
            assert d["local"] == (r if world == 2 else r % 2)
            assert d["reduced"] == pytest.approx({"a": (world + 1) / 2, "b": 2.0})
            assert d["gathered"] == [("r", i) for i in range(world)]
            assert d["max"] == 10 * (world - 1)
            # TRAIN.LR times the hosts: 2 ranks on one host keep it, 4 ranks
            # at 2 a host double it (the reference's process count)
            assert d["hosts"] == (1 if world == 2 else 2)
            assert d["lr_factor"] == pytest.approx(1.0 if world == 2 else 2.0)


def test_trials_over_ranks_equal_the_references_vmapped_trials(reference):
    runs, worlds = reference
    ref = runs["trials"]
    assert ref["plan"][0] == 8  # the reference lays its 8 trials over its 8 devices
    logits, params = {}, {}
    for r, out in enumerate(worlds[2]):
        t = out["trials"]
        assert t["plan"] == (2, 1, 1)
        ((first, p, lg),) = t["seen"]
        assert first == 4 * r and lg.shape == (4, EPOCHS, 70, K)
        for i in range(4):
            logits[first + i], params[first + i] = lg[i], _port_params_as_jax(p, i)
        # every rank returns every trial's result
        assert t["scores"] == worlds[2][0]["trials"]["scores"]
        assert np.array_equal(np.stack(t["best_logits"]), np.stack(worlds[2][0]["trials"]["best_logits"]))
        assert t["scores"] == pytest.approx(ref["scores"], abs=1e-5)
    for t in range(8):
        assert _rel_err(logits[t], ref["logits"][t]) <= 1e-5, t
        want = _flat(jax_tree_slice(ref["params"], t))
        assert params[t].keys() == want.keys()
        for name in want:
            assert _rel_err(params[t][name], want[name]) <= 1e-5, (t, name)
    # every rank holds trial 7 as its last: rank 1 trained it, rank 0 got it
    last0, last1 = worlds[2][0]["trials"]["last"], worlds[2][1]["trials"]["last"]
    for n in last0:
        assert np.array_equal(last0[n], last1[n]), n


def jax_tree_slice(tree: dict, t: int) -> dict:
    return {k: (jax_tree_slice(v, t) if isinstance(v, dict) else None if v is None else v[t])
            for k, v in tree.items()}


def test_data_parallel_final_run_equals_the_reference_with_the_scramble_live(reference):
    runs, worlds = reference
    ref = runs["final_dp"]
    assert ref["plan"][:2] == (1, 8)
    want_params = _flat(jax_tree_slice(ref["params"], 0))
    outs = [out["final_dp"] for out in worlds[2]]
    for out in outs:
        assert out["plan"] == (1, 2, 1)
        ((_, p, lg),) = out["seen"]
        got = _port_params_as_jax(p, 0)
        assert got.keys() == want_params.keys()
        for name, want in want_params.items():
            err = float(np.abs(got[name] - want).max())
            assert err <= 1e-6, (name, err)
        assert _rel_err(lg[0], ref["logits"][0]) <= 1e-5
    # both ranks hold the same trained parameters, bit for bit
    p0, p1 = outs[0]["seen"][0][1], outs[1]["seen"][0][1]
    for n in p0:
        assert np.array_equal(p0[n], p1[n]), n
    # the epochs moved the logits far beyond the tolerance
    assert np.abs(ref["logits"][0, 1] - ref["logits"][0, 0]).max() > 1e-3 * np.abs(ref["logits"]).max()


def test_a_streamed_data_parallel_final_run_equals_the_streamed_single_process_run(reference):
    runs, worlds = reference
    want = runs["final_stream_single"]
    assert want["plan"] == (1, 1, 1) and not want["seen"]  # streamed: no fit_eval
    for out in worlds[2]:
        got = out["final_dp"]["streamed"]
        assert got["plan"] == (1, 2, 1)
        for name, w in want["last"].items():
            err = float(np.abs(got["last"][name] - w).max())
            assert err <= 1e-6, (name, err)
        assert _rel_err(got["best_logits"][0], want["best_logits"][0]) <= 1e-5
        assert got["scores"] == want["scores"]


def test_a_delta_from_a_ranks_own_rows_fails(reference):
    """The control: quirk 4 gives a row its delta from a token range of every
    row, so a rank that computes the delta from its own rows only trains
    something else."""
    runs, worlds = reference
    ref = runs["final_dp"]
    ((_, _, lg),) = worlds[2][0]["final_dp"]["control"]
    assert _rel_err(lg[0], ref["logits"][0]) > 1e-3


def test_tensor_parallel_lora_equals_the_reference(reference):
    runs, worlds = reference
    ref = runs["tp"]
    assert ref["plan"] == (1, 4, 2)
    want_params = _flat(jax_tree_slice(ref["params"], 0))
    init = _flat(runs["tp"]["port"]["inits"][0][0]["peft"])
    ((_, single_p, single_lg),) = runs["tp_fast_single"]["seen"]
    single = _port_params_as_jax(single_p, 0)
    for out in worlds[4]:
        tp = out["tp"]
        assert tp["plan"] == tp["fast"]["plan"] == (1, 2, 2)
        ((_, p, lg),) = tp["seen"]
        got = _port_params_as_jax(p, 0)
        for name, want in want_params.items():
            np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=2e-6, err_msg=name)
            if name.startswith("peft."):  # the factors moved far beyond the tolerance
                assert np.abs(want - init[name[5:]]).max() > 50 * 2e-6, name
        assert np.all(np.isfinite(lg))
        assert _rel_err(lg[0], ref["logits"][0]) <= 1e-5
        ((_, p, lg),) = tp["fast"]["seen"]
        got = _port_params_as_jax(p, 0)
        for name, want in single.items():  # the reference test holds the parameters
            np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=2e-6, err_msg=name)
        assert np.all(np.isfinite(lg)) and lg.shape == single_lg.shape


@pytest.mark.parametrize("quantize", [False, True], ids=["fp-baked", "int8-args"])
def test_mesh_serving_equals_the_single_process_serving_fn(reference, quantize):
    _, worlds = reference
    for out in worlds[2]:
        s = out["final_dp"]["serve"]
        assert s["width"] == [2, 2]
        assert s["refused"]
        for batch in (8, 16):
            err, scale, alone = s["err"][(quantize, batch)]
            assert err <= 1e-5 * scale, (batch, err, scale)
            # the scramble is live: each rank's rows alone would differ
            assert alone > 1e-3 * scale


def test_gathered_contrastive_logits_equal_the_references_shard_map(reference):
    runs, worlds = reference
    ref = runs["declip"]
    d_scale = 0.0
    for r, out in enumerate(worlds[2]):
        d = out["declip"]
        for key in ("logits", "d_img", "d_txt"):
            assert _rel_err(d[key], ref[key][r]) <= 1e-5, (r, key)
        d_scale += d["d_scale"]
    # each rank's scale gradient is its share; the reference's is the sum
    assert d_scale == pytest.approx(ref["d_scale"], rel=1e-5)


def test_a_chunk_out_of_memory_on_one_rank_halves_on_every_rank(reference):
    _, worlds = reference
    outs = [out["oom"] for out in worlds[2]]
    for out in outs:
        # the chunk of 4, then its halves of 2: each rank trains one trial a half
        assert out["chunks"] == [4, 2, 2]
        assert len(out["scores"]) == 4 and all(np.isfinite(out["scores"]))
    assert outs[0]["widths"] == [2, 1, 1]  # rank 0 trained its part of the first chunk
    assert outs[1]["widths"] == [2, 1, 1]  # rank 1 ran out of memory on it
    assert outs[0]["scores"] == outs[1]["scores"]


def test_a_world_of_one_is_the_single_process_path_bit_for_bit(reference):
    _, worlds = reference
    out = worlds[1][0]["world_one"]
    before, after = out["before"], out["after"]
    assert before["plan"] == after["plan"] == (1, 1, 1)
    ((_, p0, l0),), ((_, p1, l1),) = before["seen"], after["seen"]
    assert np.array_equal(l0, l1)
    for n in p0:
        assert np.array_equal(p0[n], p1[n]), n
    assert before["scores"] == after["scores"]


if __name__ == "__main__":
    worker_main(sys.argv[1], sys.argv[2])
