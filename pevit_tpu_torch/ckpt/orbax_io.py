"""Save and restore the trained state of a run.

Counterpart of ``pevit_tpu/ckpt/orbax_io.py``.  The reference writes its
trainable partition (PEFT parameters and head; the visual tower too under
full_finetune) with Orbax, and falls back to ``step_N.npz``, keyed by
``_flatten``'s ``a/b/c`` paths, with a ``__none__`` entry for each frozen
leaf.  The card has no Orbax, so the port always writes and reads that npz
file, over the reference's tree (layers stacked, names mapped by
``bridge``): the reference's ``restore_trainable`` reads the port's files and
the port reads the reference's npz files.  An Orbax ``step_N/`` directory
raises.  The frozen backbone is not saved: it comes from its checkpoint.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from ..bridge import _tree_to_port, trainable_to_jax


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix[:-1] + "__none__"] = np.zeros(0)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten_into(target, flat: dict, prefix=""):
    """Rebuild a tree with ``target``'s structure from a ``_flatten`` dict."""
    if isinstance(target, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten_into(v, flat, f"{prefix}{i}/") for i, v in enumerate(target))
    if target is None:
        return None
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint is missing leaf {key!r}")
    ref = np.asarray(target)
    return flat[key].reshape(ref.shape).astype(ref.dtype)


def save_trainable(path: str, bundle: dict, step: int = 0) -> str:
    """Write the parameters of ``bundle`` that require a gradient (the
    trainable side of ``train.partition``) to ``path/step_{step}.npz`` in the
    reference's layout; returns the file's path."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"step_{step}.npz")
    np.savez(out, **_flatten(trainable_to_jax(bundle)))
    logging.info("=> saved checkpoint (npz) to %s", out)
    return out


def _latest_step(path: str) -> int:
    steps = set()
    for d in os.listdir(path):
        if d.startswith("step_"):
            tail = d[len("step_"):]
            if tail.endswith(".npz"):
                tail = tail[: -len(".npz")]
            try:
                steps.add(int(tail))
            except ValueError:
                continue
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path}")
    return max(steps)


def restore_trainable(path: str, bundle: dict, step: Optional[int] = None) -> dict:
    """The trained state saved under ``path`` (the latest step unless
    ``step``), for the parameters of ``bundle`` that require a gradient:
    ``{dotted name: tensor}`` on the bundle's device, keyed as
    ``train.trainable_params`` keys them."""
    if step is None:
        step = _latest_step(path)
    npz_path = os.path.join(path, f"step_{step}.npz")
    if os.path.isdir(os.path.join(path, f"step_{step}")):
        raise NotImplementedError(
            f"{path}/step_{step} is an Orbax checkpoint directory; the port reads the npz format "
            "only (step_N.npz, which the reference writes when Orbax is unavailable)")
    if not os.path.exists(npz_path):
        raise FileNotFoundError(f"no step_{step}.npz checkpoint under {path}")
    with np.load(npz_path) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten_into(trainable_to_jax(bundle), flat)
    logging.info("=> restored checkpoint (npz) from %s", npz_path)
    return _tree_to_port(tree, _device_of(bundle))


def _device_of(bundle: dict):
    for module in bundle.values():
        if module is not None:
            for p in module.parameters():
                return p.device
    raise ValueError("the bundle holds no parameters")
