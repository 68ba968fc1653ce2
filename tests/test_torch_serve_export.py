"""Exported serving artifacts: the port's ``export_classifier`` ->
``save_exported`` -> ``load_exported`` in a fresh process against the JAX
reference's ``export_classifier`` -> ``load_exported(...).call``, on the
same numpy weights (non-zero KAdaptation factors, random BN statistics),
fp32, at 1e-5.

Four artifacts a side: baked and weights-as-args, each fp and int8, each
with a symbolic batch and run at batches 1, 8, 37 and 256; and a static
batch-1 one.  The port's artifacts are loaded in a subprocess that imports
only ``pevit_tpu_torch``.  The exported graph holds the attention and
fused-MLP operators, whichever device it was traced on.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.peft import PeftConfig
from pevit_tpu.serve import export_classifier as jax_export_classifier
from pevit_tpu.serve import load_exported as jax_load_exported
from pevit_tpu.serve import save_exported as jax_save_exported
from pevit_tpu.serve import serving_weights as jax_serving_weights
from pevit_tpu.train.trainer import TaskStatic as JaxStatic
from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig
from pevit_tpu_torch.serve import (
    export_classifier,
    exported_callable,
    is_baked,
    make_serving_fn,
    save_exported,
    serving_weights,
)
from pevit_tpu_torch.train import partition, trainable_pred
from pevit_tpu_torch.train.trainer import TaskStatic

from .test_torch_bridge import (  # noqa: F401  (bnhd_layout: autouse fixture)
    NUM_CLASSES, PORT_TINY, RES, TINY, bnhd_layout, jax_bundle, port_bundle)
from .test_torch_serve import PREPROC, _images

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
BATCHES = (1, 8, 37, 256)
MODES = {"baked-fp": (True, False), "baked-int8": (True, True),
         "args-fp": (False, False), "args-int8": (False, True)}
# loads every artifact in a fresh interpreter that imports only the port
CHILD = r"""
import json, sys
import numpy as np, torch
from pevit_tpu_torch.serve import exported_callable, load_exported
job = json.loads(sys.argv[1])
images = np.load(job["images"])
out = {}
for name, art in job["artifacts"].items():
    weights = torch.load(art["weights"], weights_only=True) if art["weights"] else None
    call = exported_callable(load_exported(art["path"]), weights, device="cpu")
    for key in art["batches"]:
        out[name + "/" + key] = call(images[key]).numpy()
np.savez(job["out"], **out)
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "pevit_tpu")]
assert not leaked, leaked
"""


def _port_task():
    bundle, bn = jax_bundle(seed=0)
    static = TaskStatic(spec=PORT_TINY, peft_cfg=PortPeftConfig(method="kadaptation"),
                        num_classes=NUM_CLASSES, compute_dtype="float32")
    ported, bn_t = port_bundle(bundle, bn)
    trainable, frozen = partition(ported, trainable_pred(static))
    return static, trainable, frozen, bn_t


def _jax_task():
    bundle, bn = jax_bundle(seed=0)
    static = JaxStatic(spec=TINY, peft_cfg=PeftConfig(method="kadaptation"),
                       num_classes=NUM_CLASSES, compute_dtype="float32", use_fused_mlp=False)
    jb = jax.tree.map(jnp.asarray, bundle)
    return (static, jb, jax.tree.map(lambda _: None, jb), jax.tree.map(jnp.asarray, bn),
            {k: jnp.asarray(v) for k, v in PREPROC.items()})


def _run_child(job: dict) -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    subprocess.run([sys.executable, "-c", CHILD, json.dumps(job)], cwd=REPO, env=env,
                   check=True, timeout=600)
    with np.load(job["out"]) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{mode: (port logits by batch, JAX logits by batch)}, and the port's
    in-memory programs."""
    tmp = tmp_path_factory.mktemp("artifacts")
    images = {str(b): _images(b, seed=b) for b in BATCHES}
    np.savez(tmp / "images.npz", **images)
    static, trainable, frozen, bn_t = _port_task()
    jax_args = _jax_task()
    job = {"images": str(tmp / "images.npz"), "out": str(tmp / "out.npz"), "artifacts": {}}
    programs, want = {}, {}
    modes = {**MODES, "static": (True, False)}
    for name, (bake, quantize) in modes.items():
        dynamic = name != "static"
        ep = export_classifier(static, trainable, frozen, bn_t, PREPROC, image_size=RES,
                               dynamic_batch=dynamic, bake_weights=bake, quantize=quantize,
                               device="cpu")
        programs[name] = ep
        save_exported(ep, tmp / f"{name}.pt2")
        weights = None
        if not bake:
            weights = str(tmp / f"{name}.weights.pt")
            torch.save(serving_weights(trainable, frozen, bn_t, quantize=quantize), weights)
        batches = [str(b) for b in BATCHES] if dynamic else ["1"]
        job["artifacts"][name] = {"path": str(tmp / f"{name}.pt2"), "weights": weights,
                                  "batches": batches}
        exp = jax_export_classifier(*jax_args, image_size=RES, dynamic_batch=dynamic,
                                    bake_weights=bake, quantize=quantize)
        jax_save_exported(exp, tmp / f"{name}.stablehlo")
        loaded = jax_load_exported(tmp / f"{name}.stablehlo")
        jw = None if bake else jax_serving_weights(*jax_args[1:4], quantize=quantize)
        want[name] = {b: np.asarray(loaded.call(jnp.asarray(images[b])) if bake
                                    else loaded.call(jw, jnp.asarray(images[b])))
                      for b in batches}
    got = _run_child(job)
    sizes = {name: (tmp / f"{name}.pt2").stat().st_size for name in modes}
    return {name: ({b: got[f"{name}/{b}"] for b in want[name]}, want[name]) for name in modes}, \
        programs, sizes


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mode", MODES)
def test_artifact_in_a_fresh_process_matches_jax(artifacts, mode, batch):
    got, want = artifacts[0][mode]
    assert got[str(batch)].shape == (batch, NUM_CLASSES)
    np.testing.assert_allclose(got[str(batch)], want[str(batch)], **TOL)


def test_static_batch_artifact(artifacts):
    got, want = artifacts[0]["static"]
    np.testing.assert_allclose(got["1"], want["1"], **TOL)
    call = exported_callable(artifacts[1]["static"], device="cpu")
    with pytest.raises(Exception, match="shape|size|Expected"):
        call(_images(2))


@pytest.mark.parametrize("mode", MODES)
def test_graph_holds_the_kernel_operators(artifacts, mode):
    """Each block's attention core and fused MLP are operator nodes, which
    choose kernel or plain version by device when they run."""
    ep = artifacts[1][mode]
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    layers = PORT_TINY.vision.layers
    assert targets.count("pevit_tpu_torch.attention_fwd.default") == layers
    assert targets.count("pevit_tpu_torch.fused_mlp_fwd.default") == layers
    assert is_baked(ep) == mode.startswith("baked")


def test_baked_artifacts_hold_the_tower_not_the_text_tower(artifacts):
    programs, sizes = artifacts[1], artifacts[2]
    names = set(programs["baked-fp"].state_dict)
    assert any("visual" in n for n in names) and not any("text" in n for n in names)
    assert sizes["baked-int8"] < sizes["baked-fp"]
    # a program-only artifact holds preproc and no weight
    assert set(programs["args-fp"].state_dict) == {"pre_mean", "pre_std"}


def test_artifact_matches_the_in_process_serving_fn(artifacts):
    """The in-memory program and make_serving_fn run the same forward."""
    static, trainable, frozen, bn_t = _port_task()
    for mode, (bake, quantize) in MODES.items():
        if not bake:
            continue
        serve = make_serving_fn(static, trainable, frozen, bn_t, PREPROC, quantize=quantize,
                                device="cpu")
        x = _images(5, seed=5)
        got = exported_callable(artifacts[1][mode], device="cpu")(x)
        np.testing.assert_array_equal(got.numpy(), serve(x).numpy())


# forward_fn (an auxiliary backbone's forward) is ported; a mesh still
# raises with it (tests/test_torch_backbone_probe.py serves and exports it)
@pytest.mark.parametrize("option", [{"mesh": object()},
                                    {"forward_fn": lambda p, x, t, g=None: x, "mesh": object()},
                                    {"platforms": ("cuda",)}])
def test_unported_options_raise(option):
    static, trainable, frozen, bn_t = _port_task()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        export_classifier(static, trainable, frozen, bn_t, PREPROC, image_size=RES,
                          device="cpu", **option)


def test_weights_must_match_the_artifact(artifacts):
    static, trainable, frozen, bn_t = _port_task()
    with pytest.raises(ValueError, match="weights"):
        exported_callable(artifacts[1]["args-fp"], device="cpu")
    with pytest.raises(ValueError, match="weights"):
        exported_callable(artifacts[1]["baked-fp"], serving_weights(trainable, frozen, bn_t),
                          device="cpu")
