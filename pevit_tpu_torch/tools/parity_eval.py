"""Accuracy-parity harness over the reference's 20-dataset ELEVATER grid,
through the port's commands.

Counterpart of ``tools/parity_eval.py``: it runs method x dataset x seed
through the same command mains the launch scripts use
(``pevit_tpu_torch.commands``) and reports each dataset's top-1 and the
20-dataset average beside the reference's published numbers (BASELINE.md,
from the reference README.md:84-89).

Real parity needs a machine with (1) the OpenAI CLIP checkpoint
(``--weights ViT-B-32.pt``) and (2) the ELEVATER datasets under
``--data-root/<dataset>/`` in a layout ``data.sources`` reads (the
``{split}.npz`` that ``tools/prepare_dataset.py`` writes on a host with
PIL).  ``--smoke`` runs the whole harness offline instead, on synthetic
data and random weights, on the CPU:

    python -m pevit_tpu_torch.tools.parity_eval --methods kadaptation --seeds 0,1,2 \\
        --data-root /data/elevater --weights ~/.cache/clip/ViT-B-32.pt
    python -m pevit_tpu_torch.tools.parity_eval --smoke --methods linear_probe \\
        --datasets cifar10 --seeds 0

``--model`` names a YAML of ``resources/model/`` or is a path to one.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import logging
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# method -> (command module, published 5-shot 20-dataset average top-1,
# published trainable parameters): reference README.md:84-89
METHODS = {
    "kadaptation": ("pevit_tpu_torch.commands.kronecker_adaptation_clip", 68.92, 79_699),
    "adapter": ("pevit_tpu_torch.commands.adapter_clip", 65.08, 1_237_587),
    "lora": ("pevit_tpu_torch.commands.lora_clip", 61.48, 176_979),
    "compacter": ("pevit_tpu_torch.commands.compacter_clip", 62.79, 77_907),
    "full_finetune": ("pevit_tpu_torch.commands.finetune", 65.49, 87_878_739),
    "linear_probe": ("pevit_tpu_torch.commands.linear_probe", 66.32, 29_523),
    # the eval-only arm: no published 20-dataset average
    "zeroshot": ("pevit_tpu_torch.commands.zeroshot", None, 0),
}

ALL_DATASETS = [
    "caltech101", "cifar10", "cifar100", "country211", "dtd", "eurosat-clip",
    "fer2013", "fgvc-aircraft-2013b", "flower102", "food101", "gtsrb",
    "hateful-memes", "kitti-distance", "mnist", "oxford-iiit-pets",
    "patchcamelyon", "rendered-sst2", "resisc45-clip", "stanfordcar",
    "voc2007classification",
]


def model_yaml(model: str) -> Path:
    """``--model``: a path to a YAML, or a name under resources/model/."""
    path = Path(model)
    return path if path.suffix == ".yaml" else REPO / "resources" / "model" / f"{model}.yaml"


def command_argv(method: str, dataset: str, seed: int, args) -> list:
    """The command line the harness hands ``method``'s main for one
    (dataset, seed)."""
    argv = ["--ds", str(REPO / "resources" / "datasets" / f"{dataset}.yaml"),
            "--model", str(model_yaml(args.model))]
    if method != "zeroshot":  # eval only: no trainer flags
        argv += ["--no-tuning", str(args.no_tuning), "--lr", str(args.lr), "--l2", str(args.l2)]
    if args.device:  # before the KEY VALUE overrides, which take the rest of the line
        argv += ["--device", args.device]
    argv += [
        "DATASET.NUM_SAMPLES_PER_CLASS", str(args.shots),
        "DATASET.RANDOM_SEED_SAMPLING", str(seed),
        "OUTPUT_DIR", str(Path(args.output_dir) / method),
    ]
    if args.data_root:
        argv += ["DATASET.ROOT", str(Path(args.data_root) / dataset)]
    if args.weights:
        argv += ["MODEL.PRETRAINED", args.weights]
    if args.smoke:
        argv += [
            "MODEL.PRETRAINED", "random",
            "DATASET.ALLOW_SYNTHETIC", "True",
            "DATASET.ROOT", str(Path(args.output_dir) / "data" / dataset),
            "TRAIN.END_EPOCH", "2", "TRAIN.EXTRA_FINAL_TRAIN_EPOCH", "0",
            "TRAIN.IMAGE_SIZE", "[32,32]", "TEST.IMAGE_SIZE", "[32,32]",
            "TPU.COMPUTE_DTYPE", "float32",
        ]
    return argv


def run_one(method: str, dataset: str, seed: int, args) -> tuple:
    """(best top-1, model info) of one (method, dataset, seed)."""
    mod = importlib.import_module(METHODS[method][0])
    out = mod.main(command_argv(method, dataset, seed, args))
    if method == "zeroshot":  # the zero-shot command returns its metric alone
        return float(out), {}
    best, model_info = out
    return float(best), model_info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--methods", default="kadaptation")
    ap.add_argument("--datasets", default=",".join(ALL_DATASETS))
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--shots", type=int, default=5)
    ap.add_argument("--model", default="vitb32_CLIP", help="a resources/model name, or a YAML path")
    ap.add_argument("--data-root", default="", help="ELEVATER root: <root>/<dataset>/...")
    ap.add_argument("--weights", default="", help="OpenAI CLIP .pt checkpoint path")
    ap.add_argument("--no-tuning", default="False", help="False = the reference's sweep")
    ap.add_argument("--lr", type=float, default=0.0)
    ap.add_argument("--l2", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu; --smoke: cpu")
    ap.add_argument("--output-dir", default="parity_out")
    ap.add_argument("--report", default="parity_report.json")
    ap.add_argument("--merge", action="store_true",
                    help="update --report in place: keep the methods recorded there, "
                         "overwrite or add the ones run now")
    ap.add_argument("--tolerance", type=float, default=0.3, help="acceptance band (points)")
    ap.add_argument("--smoke", action="store_true",
                    help="offline harness check: synthetic data, random weights, 2 epochs, "
                         "on the CPU")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.smoke:
        args.no_tuning, args.lr, args.l2 = "True", 0.01, 1e-4
        args.device = args.device or "cpu"

    methods = [m.strip() for m in args.methods.split(",")]
    datasets = [d.strip() for d in args.datasets.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    report = {"config": {"shots": args.shots, "model": args.model, "seeds": seeds,
                         "smoke": bool(args.smoke)}, "methods": {}}
    if args.merge and Path(args.report).exists():
        prior = json.loads(Path(args.report).read_text())
        if prior.get("config", {}).get("shots") != args.shots:
            raise ValueError("--merge across different shot counts would mix grids")
        report["methods"].update(prior.get("methods", {}))
    for method in methods:
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r} (choices: {list(METHODS)})")
        per_ds = {}
        t0 = time.time()
        for ds in datasets:
            scores = []
            for seed in seeds:
                best, _ = run_one(method, ds, seed, args)
                scores.append(best)
                logging.info("%s/%s seed %d: %.3f", method, ds, seed, best)
            per_ds[ds] = {"per_seed": scores, "mean": sum(scores) / len(scores)}
        avg = sum(v["mean"] for v in per_ds.values()) / len(per_ds)
        published = METHODS[method][1]
        report["methods"][method] = {
            "per_dataset": per_ds,
            "average_top1": avg,
            "published_average_top1": published,
            "delta": None if published is None else avg - published,
            "within_tolerance": None if published is None else abs(avg - published) <= args.tolerance,
            "wall_s": time.time() - t0,
        }
        if published is None:
            logging.info("%s: avg %.2f (no published average)", method, avg)
        else:
            logging.info("%s: avg %.2f vs published %.2f (delta %+.2f)%s", method, avg, published,
                         avg - published,
                         "  [smoke: synthetic data, the delta means nothing]" if args.smoke else "")
        # written after every method: a stopped grid keeps its finished arms
        Path(args.report).write_text(json.dumps(report, indent=2))
        gc.collect()
    logging.info("report -> %s", args.report)
    return report


if __name__ == "__main__":
    main()
