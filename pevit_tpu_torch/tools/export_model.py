"""Export a (trained) classifier to a ``torch.export`` serving artifact.

Counterpart of ``tools/export_model.py``.  Builds the model as the training
commands do (the same YAML configs and ``KEY VALUE`` override grammar),
restores the trained state from a ``step_N.npz`` directory
(``TPU.CHECKPOINT_DIR`` / ``--ckpt-dir``), and saves the eval forward
(``pevit_tpu_torch.serve.export_classifier``, symbolic batch) as ``.pt2``:

    python -m pevit_tpu_torch.tools.export_model \\
        --model resources/model/vitb32_CLIP.yaml \\
        --ds resources/datasets/cifar10.yaml \\
        --method kadaptation --ckpt-dir /ckpts/cifar10 \\
        --out cifar10_kadapt.pt2 MODEL.PRETRAINED /weights/ViT-B-32.pt

The artifact replays with no model code:

    from pevit_tpu_torch.serve import exported_callable, load_exported
    logits = exported_callable(load_exported("cifar10_kadapt.pt2"))(images_u8)

MODEL.NAME may name a CLIP (ViT or RN) or, for ``--method linear_probe``
or ``full_finetune``, an auxiliary backbone of ``models.get_model``, whose
forward the artifact then holds.  The reference's flags, and ``--device`` (``cuda`` by default; ``cpu``
traces on the CPU; an artifact runs on whichever device it is given).
``--platforms`` and ``--mesh`` raise: neither has a counterpart yet.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, help="model YAML (resources/model/*.yaml)")
    ap.add_argument("--ds", default="", help="dataset YAML (sets NUM_CLASSES for the head)")
    ap.add_argument("--method", default="kadaptation",
                    help="kadaptation | lora | adapter | compacter | linear_probe | full_finetune")
    ap.add_argument("--ckpt-dir", default="", help="directory with the trained state, "
                    "step_N.npz (default: config TPU.CHECKPOINT_DIR; empty = fresh init)")
    ap.add_argument("--out", default="classifier.pt2")
    ap.add_argument("--static-batch", action="store_true",
                    help="export with a fixed batch of 1 instead of a symbolic batch dim")
    ap.add_argument("--weights-as-args", action="store_true",
                    help="program-only artifact; the weights ship separately "
                    "(serving_weights(...)) and are passed in every call")
    ap.add_argument("--quantize", action="store_true",
                    help="weight-only per-channel int8 (pevit_tpu_torch/quant.py): ~4x smaller "
                    "artifact / weight bundle, dequantized inside every call. With "
                    "--weights-as-args, call with serving_weights(..., quantize=True)")
    ap.add_argument("--platforms", default="",
                    help="not ported: an artifact picks its device when it runs")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="not ported: a data-parallel artifact over N devices")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = ap.parse_args(argv)

    from ..serve import export_classifier, save_exported
    from ..serve_daemon import config_from
    from ..serving_loader import build_task, restore_into
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    config = config_from(args.ds, args.model, args.opts)
    task, static, trainable, frozen, bn_state = build_task(config, args.method, args.seed, dev,
                                                           backbones=True)
    ckpt_dir = args.ckpt_dir or config.TPU.CHECKPOINT_DIR
    if ckpt_dir:
        restore_into(ckpt_dir, trainable)
        print(f"restored trained state from {ckpt_dir}")
    else:
        print("NO checkpoint dir given: exporting the fresh-init model")

    exported = export_classifier(
        static, trainable, frozen, bn_state, task.preproc,
        image_size=config.TRAIN.IMAGE_SIZE[0],
        dynamic_batch=not args.static_batch,
        bake_weights=not args.weights_as_args,
        quantize=args.quantize,
        device=dev,
        platforms=[p for p in args.platforms.split(",") if p] or None,
        mesh=args.mesh or None,
        forward_fn=task._forward_fn,
    )
    save_exported(exported, args.out)
    size_mb = Path(args.out).stat().st_size / 1e6
    inputs = [str(n.meta["val"].shape) for n in exported.graph.nodes
              if n.op == "placeholder" and n.name in exported.graph_signature.user_inputs][-1:]
    print(f"exported {args.out}: {size_mb:.1f} MB, images {inputs}, "
          f"weights {'as arguments' if args.weights_as_args else 'baked'}, "
          f"traced on {dev}")
    return exported


if __name__ == "__main__":
    main()
