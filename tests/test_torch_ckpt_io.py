"""The port's ``save_trainable`` / ``restore_trainable`` against
pevit_tpu/ckpt/orbax_io.py's npz format, on the tiny ViT of
tests/test_torch_trainer.py, for KAdaptation, the linear probe and full
fine-tuning:

* port -> port: the restored state equals the saved one bit for bit;
* port -> JAX: the reference's ``restore_trainable`` reads the port's file
  into its own trainable tree, bit for bit;
* JAX npz -> port: the port reads the file the reference writes when Orbax
  is unavailable, bit for bit;
* an Orbax ``step_N/`` directory raises;
* ``run_method`` with TPU.CHECKPOINT_DIR writes the file the reference's
  ``run_method`` writes: the same step, keys and shapes.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from pevit_tpu.ckpt import orbax_io as jio
from pevit_tpu.train import sweep as jsweep
from pevit_tpu.train.partition import combine as jcombine
from pevit_tpu_torch import bridge
from pevit_tpu_torch.ckpt import restore_trainable, save_trainable
from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig
from pevit_tpu_torch.train import combine, partition, sweep as psweep, trainable_params, \
    trainable_pred

from .test_torch_trainer import PORT_TINY, _data, _method_tasks, clip_params  # noqa: F401

METHODS = ["kadaptation", "linear_probe", "full_finetune"]


@pytest.fixture
def no_orbax(monkeypatch):
    """The reference's save without Orbax: it falls back to the npz file."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _port_bundle(jtask, ptask, method):
    """The JAX task's trial-0 bundle, and the same bundle in the port,
    partitioned as the port's task partitions it."""
    trainable, frozen, _ = jtask.init_bundle(jax.random.PRNGKey(0))
    bundle, _ = bridge.from_jax(jax.tree.map(np.asarray, jcombine(trainable, frozen)),
                                {"mean": np.zeros(1), "var": np.ones(1)}, PORT_TINY,
                                PortPeftConfig(method=method), device="cpu")
    t_tree, f_tree = partition(bundle, trainable_pred(ptask.static))
    return trainable, combine(t_tree, f_tree), trainable_params(t_tree)


def _perturbed(params):
    """Trained-looking values, so that a restore cannot pass on the init."""
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in params.values():
            p.add_(torch.randn(p.shape, generator=gen))
    return {n: p.detach().clone() for n, p in params.items()}


@pytest.mark.parametrize("method", METHODS)
def test_port_round_trip_and_jax_reads_the_port_file(clip_params, tmp_path, method):
    jtask, ptask = _method_tasks(clip_params, method)
    jtrainable, bundle, params = _port_bundle(jtask, ptask, method)
    want = _perturbed(params)
    path = save_trainable(str(tmp_path), bundle, step=7)
    assert path.endswith("step_7.npz")
    got = restore_trainable(str(tmp_path), bundle)
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name

    restored = jio.restore_trainable(str(tmp_path), jtrainable)
    flat_j = jio._flatten(jax.tree.map(np.asarray, restored))
    flat_p = jio._flatten(bridge.trainable_to_jax(bundle))
    assert flat_j.keys() == flat_p.keys()
    assert any(k.endswith("__none__") for k in flat_j)
    for k, v in flat_p.items():
        assert flat_j[k].dtype == v.dtype and flat_j[k].shape == v.shape, k
        np.testing.assert_array_equal(flat_j[k], v, err_msg=k)


@pytest.mark.parametrize("method", METHODS)
def test_port_reads_the_reference_npz(clip_params, tmp_path, no_orbax, method):
    jtask, ptask = _method_tasks(clip_params, method)
    jtrainable, bundle, params = _port_bundle(jtask, ptask, method)
    rng = np.random.default_rng(6)
    trained = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(np.float32),
                           jtrainable)
    jio.save_trainable(str(tmp_path), trained, step=3)
    assert (tmp_path / "step_3.npz").exists() and not (tmp_path / "step_3").exists()
    got = restore_trainable(str(tmp_path), bundle, step=3)
    want = bridge._tree_to_port(jax.tree.map(np.asarray, trained), torch.device("cpu"))
    assert got.keys() == want.keys() == params.keys()
    for name, t in want.items():
        assert torch.equal(got[name], t), name


def test_an_orbax_directory_raises(clip_params, tmp_path):
    jtask, ptask = _method_tasks(clip_params, "kadaptation")
    _, bundle, _ = _port_bundle(jtask, ptask, "kadaptation")
    save_trainable(str(tmp_path), bundle, step=1)
    (tmp_path / "step_2").mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        restore_trainable(str(tmp_path), bundle)
    assert set(restore_trainable(str(tmp_path), bundle, step=1)) == \
        set(trainable_params(partition(bundle, trainable_pred(ptask.static))[0]))
    with pytest.raises(FileNotFoundError):
        restore_trainable(str(tmp_path / "empty_dir_missing"), bundle, step=4)


@pytest.mark.parametrize("method", ["kadaptation", "full_finetune"])
def test_run_method_writes_the_reference_keys(clip_params, tmp_path, no_orbax, method):
    images, labels = _data(10, seed=20)
    data = (images[:6], labels[:6], images[6:8], labels[6:8], images[8:], labels[8:])
    files = {}
    for name, mod in (("jax", jsweep), ("port", psweep)):
        jtask, ptask = _method_tasks(clip_params, method)
        task = jtask if name == "jax" else ptask
        cfg = task.config
        cfg.defrost()
        cfg.TRAIN.END_EPOCH, cfg.TRAIN.EXTRA_FINAL_TRAIN_EPOCH = 1, 1
        cfg.TPU.CHECKPOINT_DIR = str(tmp_path / name)
        cfg.freeze()
        mod.run_method(task, data, cfg, no_tuning=True, lr=0.01, l2=1e-4)
        (f,) = (tmp_path / name).iterdir()
        files[name] = f
        assert f.name == "step_2.npz"
    with np.load(files["jax"]) as zj, np.load(files["port"]) as zp:
        assert set(zp.files) == set(zj.files)
        for k in zj.files:
            assert zp[k].shape == zj[k].shape and zp[k].dtype == zj[k].dtype, k
