"""The training commands' shared flow.

Counterpart of ``pevit_tpu/commands/_common.py``, with the reference's
command surface (``--ds/--model`` double YAML merge, ``--no-tuning/--lr/
--l2/--run/--fix_seed/--save-predictions`` and yacs ``KEY VALUE``
overrides), its dataset tweaks (1-shot -> 2-shot with
MERGE_TRAIN_VAL_FINAL_RUN off, the patch-camelyon 10000-shot sweep subset),
the prediction JSON with its float-precision dump, the summary TXT with the
exact ``best acc is:...`` strings that ``read_results.py`` and
``read_txt.py`` parse, and the completion sidecar that replays a finished
job instead of training it again.

The linear probe adds ``--emulate-zeroshot``; ``--submit-predictions``
validates the submission (the reference posts nothing either).  One option
is the port's own: ``--device`` (default ``cuda``; ``cpu`` runs the command
on the CPU, as the tests do).

MODEL.NAME picks the backbone: a CLIP (``ViT-*`` or ``RN*``) through
``load_clip``, anything else through ``models.get_model`` (linear probe and
finetune only; the MAE linear probe turns its global pool off, as the
reference's does).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import random

import numpy as np
import torch

from ..config import get_default_config, update_config
from ..utils import create_logger, dist as comm, log_config
from ..utils.device import resolve_device

# the reference's exp_name prefix of each command; every PEFT command shares
# 'finetuning' (commands/kronecker_adaptation_clip.py:113, lora_clip.py:68,
# adapter_clip.py:69, compacter_clip.py:112, finetune.py:68; linear_probe.py:79)
EXP_PREFIX = {"kadaptation": "finetuning", "lora": "finetuning", "adapter": "finetuning",
              "compacter": "finetuning", "linear_probe": "linear_probe",
              "full_finetune": "finetuning"}


def add_common_args(parser, *, probe: bool = False):
    parser.add_argument("--ds", required=False, help="Evaluation dataset configure file name.", type=str)
    parser.add_argument("--model", required=True, help="Evaluation model configure file name", type=str)
    parser.add_argument("--submit-predictions", help="submit predictions and model info to leaderboard.", default=False, action="store_true")
    parser.add_argument("--submit-by", help="Person who submits the results.", type=str)
    parser.add_argument("--no-tuning", help="No hyperparameter-tuning.", default=False, type=lambda x: str(x).lower() == "true")
    if probe:
        # a string, as in the reference: any value given turns it on
        parser.add_argument("--emulate-zeroshot", help="Emulate zero shot learning.", default=False, type=str)
    parser.add_argument("--l2", help="(Inverse) L2 regularization strength. Only used with --no-tuning True.", default=0.316, type=float)
    parser.add_argument("--lr", help="Learning rate. Only used with --no-tuning True.", default=0.001, type=float)
    parser.add_argument("--run", help="Run id", default=1, type=int)
    parser.add_argument("--fix_seed", help="Fix the random seed. [-1] not fixing the seeds", default=0, type=int)
    parser.add_argument("--save-predictions", help="save predictions logits for analysis.", default=True, action="store_true")
    parser.add_argument("--device", help="cuda (default) or cpu.", default=None, type=str)
    parser.add_argument("opts", help="Modify config options using the command-line", default=None, nargs=argparse.REMAINDER)
    return parser


def setup_config(args):
    config = get_default_config()
    args.cfg = args.ds
    if args.ds:
        update_config(config, args)
    args.cfg = args.model
    update_config(config, args)
    config.defrost()
    config.NAME = ""
    config.freeze()

    if args.submit_predictions:
        assert args.submit_by

    # LOSS.LOSS: the reference wires only 'softmax' (feature.py:288-296);
    # anything else would train the wrong objective silently
    if config.LOSS.LOSS != "softmax":
        raise ValueError(
            f"LOSS.LOSS={config.LOSS.LOSS!r} is not supported: only 'softmax' "
            "is wired (the reference's 'contrast' branch is vestigial - "
            "feature.py:295-296 never sets a forward)")

    if args.fix_seed != -1:
        random.seed(args.fix_seed)
        np.random.seed(args.fix_seed)
    return config


def apply_shared_dataset_tweaks(config, exp_base: str):
    """The 1-shot bump, the experiment name and the patch-camelyon subset."""
    n_samples = (
        str(config.DATASET.NUM_SAMPLES_PER_CLASS)
        if config.DATASET.NUM_SAMPLES_PER_CLASS > 0
        else "full"
    )
    exp_name = f"{exp_base}_{n_samples}"
    if config.TRAIN.TWO_LR:
        exp_name += "_two_lr"

    if config.DATASET.NUM_SAMPLES_PER_CLASS == 1:
        config.defrost()
        config.DATASET.NUM_SAMPLES_PER_CLASS = 2
        config.DATASET.MERGE_TRAIN_VAL_FINAL_RUN = False
        config.freeze()

    if config.DATASET.DATASET == "patch-camelyon" and config.DATASET.NUM_SAMPLES_PER_CLASS == -1:
        logging.info("Detecting large dataset with %d-shot.", config.DATASET.NUM_SAMPLES_PER_CLASS)
        config.defrost()
        config.DATASET.NUM_SAMPLES_PER_CLASS = 10000
        config.freeze()
        logging.info("Used the subset (%d-shot) to train the model.", config.DATASET.NUM_SAMPLES_PER_CLASS)
    return exp_name


def json_prec_dump(data, prec: int = 6) -> str:
    return json.dumps(json.loads(json.dumps(data), parse_float=lambda x: round(float(x), prec)))


def _artifact_tag(config) -> str:
    return f"seed{config.DATASET.RANDOM_SEED_SAMPLING}_{config.DATASET.DATASET}"


def dump_artifacts(config, exp_name: str, best_acc: float, model_info: dict, *, txt: bool = True):
    test_predictions = model_info.get("best_logits")
    results_dict = {
        "model_name": config.MODEL.NAME,
        "dataset_name": config.DATASET.DATASET,
        "num_trainable_params": model_info.get("n_trainable_params", None),
        "num_params": model_info.get("n_params", None),
        "num_visual_params": model_info.get("n_visual_params", None),
        "num_backbone_params": model_info.get("n_backbone_params", None),
        "n_shot": config.DATASET.NUM_SAMPLES_PER_CLASS,
        "rnd_seeds": [config.DATASET.RANDOM_SEED_SAMPLING],
        "predictions": [test_predictions.tolist()] if test_predictions is not None else [],
    }
    prediction_folder = os.path.join(config.OUTPUT_DIR, "predictions", exp_name)
    os.makedirs(prediction_folder, exist_ok=True)
    tag = _artifact_tag(config)
    with open(os.path.join(prediction_folder, f"{tag}.json"), "w") as f:
        f.write(json_prec_dump(results_dict))
    if txt:
        num_params = model_info.get("n_params", None)
        num_trainable_params = model_info.get("n_trainable_params", None)
        n_backbone_params = model_info.get("n_backbone_params", None)
        with open(os.path.join(prediction_folder, f"{tag}.txt"), "w") as f:
            f.write(
                f"best acc is:{best_acc}, num_params is:{num_params}, "
                f"n_trainable_params is:{num_trainable_params / 1000000}, "
                f"backbone_params is:{n_backbone_params}."
            )
    return prediction_folder


def _completion_path(config, exp_name: str) -> str:
    # '.json.complete', not '.complete.json': tools that glob seed*.json
    # must never read it
    return os.path.join(
        config.OUTPUT_DIR, "predictions", exp_name, f"{_artifact_tag(config)}.json.complete"
    )


def job_fingerprint(config, data, method: str, args) -> str:
    """Content key of one job: config, data, method and the command line's
    hyperparameters, on ``sweep_fingerprint``'s invalidation rules (which
    hash the method)."""
    from ..train.sweep_cache import sweep_fingerprint

    seed = args.fix_seed if args.fix_seed != -1 else 0
    base = sweep_fingerprint(config, data, config.TRAIN.END_EPOCH, seed, method)
    extra = f"no_tuning={args.no_tuning};lr={args.lr};l2={args.l2}"
    return hashlib.sha256(f"{base};{extra}".encode()).hexdigest()[:24]


def load_completed_job(config, exp_name: str, fingerprint: str):
    """``(best_acc, model_info)`` of a finished identical job, valid only
    when both the sidecar (with this fingerprint) and the prediction JSON
    exist; deleting either runs the job again."""
    path = _completion_path(config, exp_name)
    art = path[: -len(".complete")]
    if not (os.path.exists(path) and os.path.exists(art)):
        return None
    try:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("fingerprint") != fingerprint:
            return None
        with open(art) as f:
            preds = json.load(f).get("predictions") or []
        model_info = dict(rec["model_info"])
        model_info["best_logits"] = np.asarray(preds[0], np.float32) if preds else None
        return float(rec["best_acc"]), model_info
    except (ValueError, KeyError, OSError):
        logging.warning("job completion sidecar %s unreadable; re-running", path)
        return None


def mark_job_complete(config, exp_name: str, fingerprint: str, best_acc: float, model_info: dict):
    info = {
        k: v for k, v in model_info.items()
        if isinstance(v, (int, float, str, bool, type(None)))
    }
    payload = {"fingerprint": fingerprint, "best_acc": float(best_acc), "model_info": info}
    path = _completion_path(config, exp_name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def load_device_data(config, device=None):
    """The splits: (train_x, train_y, val_x, val_y, test_x, test_y), images
    uint8, labels int32 (float32 multi-hot for multilabel datasets).  A split
    within TPU.MAX_DEVICE_DATA_GB goes to ``device`` as tensors; a larger one
    stays in host memory as numpy, and the trainer streams it
    (``train/streaming.py``)."""
    from ..data.registry import get_dataset_info
    from ..data.sources import build_splits

    dev = resolve_device(device)
    info = get_dataset_info(config.DATASET.DATASET)
    train, val, test = build_splits(config)
    max_bytes = float(config.TPU.MAX_DEVICE_DATA_GB) * 1e9

    def prep(ds):
        labels = ds.labels
        if info.multilabel and labels.ndim == 1:
            onehot = np.zeros((len(labels), config.DATASET.NUM_CLASSES), np.float32)
            onehot[np.arange(len(labels)), labels.astype(int)] = 1
            labels = onehot
        labels = labels.astype(np.float32 if labels.ndim == 2 else np.int32)
        if ds.images.nbytes > max_bytes:
            return ds.images, labels
        return torch.from_numpy(np.ascontiguousarray(ds.images)).to(dev), torch.from_numpy(labels).to(dev)

    return prep(train) + prep(val) + prep(test)


def backbone_text_features(config, backbone) -> np.ndarray:
    """Zero-shot classifier weights (feat_dim, K) from an auxiliary
    backbone's text tower, tokenized with its own tokenizer (the DeCLIP
    family's shifted vocabulary) or CLIP's, truncating: each prompt's
    feature normalised, averaged over the class's prompts and normalised
    again, as ``extract_text_features`` does for a CLIP."""
    from ..data.tokenizer import tokenize
    from ..evaluation.text_features import build_prompts

    texts, offsets = build_prompts(config)
    length = config.MODEL.SPEC.TEXT.CONTEXT_LENGTH
    if backbone.tokenize is not None:
        toks = backbone.tokenize(texts, length)
    else:
        toks = tokenize(texts, length, truncate=True)
    dev = next(backbone.params.parameters()).device
    with torch.no_grad():
        emb = backbone.encode_text(backbone.params, torch.from_numpy(toks).to(dev, torch.long))
    emb = emb.float().cpu().numpy()
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12
    cols = []
    for s, e in offsets:
        m = emb[s:e].mean(0)
        cols.append(m / (np.linalg.norm(m) + 1e-12))
    return np.stack(cols, axis=1)


def run_training_command(method: str, *, description: str, probe: bool = False, argv=None):
    """The shared main() of the training commands; returns (best_acc,
    model_info)."""
    parser = argparse.ArgumentParser(description=description)
    add_common_args(parser, probe=probe)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    config = setup_config(args)

    if probe and getattr(args, "emulate_zeroshot", False):
        # the head from text features, evaluated without a train step
        # (linear_probe.py:69-76)
        args.no_tuning = True
        config.defrost()
        config.TRAIN.END_EPOCH = 1
        config.TRAIN.EXTRA_FINAL_TRAIN_EPOCH = 0
        config.DATASET.NUM_SAMPLES_PER_CLASS = 0
        config.TRAIN.EMULATE_ZERO_SHOT = True
        config.freeze()

    name = config.MODEL.NAME
    is_clip = name.startswith(("ViT-B", "ViT-L", "RN"))
    if not is_clip and method not in ("linear_probe", "full_finetune"):
        raise ValueError(
            f"PEFT method {method!r} requires a CLIP backbone; MODEL.NAME={name!r} "
            "is only supported for linear_probe/finetune (reference parity)")

    exp_name = apply_shared_dataset_tweaks(config, EXP_PREFIX[method])
    final_output_dir = create_logger(config, exp_name)
    if config.TPU.SWEEP_CACHE_DIR == "auto":
        # a re-run of the same command in the same output dir replays the
        # finished sweep trials; the fingerprint keys out any change
        config.defrost()
        config.TPU.SWEEP_CACHE_DIR = os.path.join(final_output_dir, "sweep_cache")
        config.freeze()
    if comm.is_main_process():
        log_config(config, args)

    from ..ckpt import load_clip
    from ..core.clip import CLIPSpec
    from ..evaluation import extract_text_features
    from ..peft import PeftConfig
    from ..train import TaskStatic, TrainTask, run_method

    data = load_device_data(config, device)

    job_fp = None
    if config.TPU.SKIP_COMPLETED_JOBS and args.save_predictions:
        job_fp = job_fingerprint(config, data, method, args)
        done = load_completed_job(config, exp_name, job_fp)
        if done is not None:
            best_acc, model_info = done
            logging.info(
                "=> job already complete (fingerprint %s): replaying recorded result, "
                "skipping training. Delete %s to force a re-run.",
                job_fp, _completion_path(config, exp_name),
            )
            _maybe_submit(args, config, model_info)
            logging.info("=> Finished: best %s = %.3f", config.TEST.METRIC or "accuracy", best_acc)
            return best_acc, model_info

    backbone, feat_dim = None, 0
    if is_clip:
        from ..core.resnet import RN_SPECS

        # the launch scripts pass TEST.MODEL_FILE '.' as "no checkpoint"
        model_file = config.TEST.MODEL_FILE if config.TEST.MODEL_FILE != "." else ""
        # an RN name carries its architecture (RN_SPECS or the checkpoint's
        # keys); the config's spec describes a ViT and must not shadow it
        clip, spec = load_clip(name, checkpoint_path=model_file or config.MODEL.PRETRAINED or None,
                               seed=args.fix_seed,
                               spec_hint=None if name in RN_SPECS else CLIPSpec.from_config(config),
                               device=device)
        if spec.vision_rn is not None and PeftConfig(method=method).has_peft_params:
            # the reference raises this at the first forward
            raise ValueError("PEFT hooks are ViT-only; RN towers load frozen (reference parity)")
        text_encode = lambda: extract_text_features(config, clip, spec)
    else:
        if probe and name.startswith("mae_"):
            # the MAE linear probe turns the global pool off (linear_probe.py:88-91)
            config.defrost()
            config.MODEL.SPEC.GLOBAL_POOL = False
            config.freeze()
        from ..models import get_model

        backbone = get_model(config, device=device)
        clip, spec, feat_dim = None, CLIPSpec.from_config(config), backbone.feat_dim
        text_encode = None
        if backbone.encode_text is not None:
            text_encode = lambda: backbone_text_features(config, backbone)

    text_weights = None
    if config.TRAIN.INIT_HEAD_WITH_TEXT_ENCODER and text_encode is not None:
        try:
            text_weights = text_encode()
        except ValueError as e:
            logging.warning("text head init unavailable (%s); using random head init", e)

    static = TaskStatic.from_config(config, spec, PeftConfig(method=method), feat_dim=feat_dim)
    task = TrainTask(config, static, clip, text_init_weights=text_weights, device=device,
                     backbone=backbone)

    logging.info("Running %s. This may take several minutes to hours depending on the data size.", method)
    best_acc, model_info = run_method(
        task, data, config,
        no_tuning=args.no_tuning, lr=args.lr, l2=args.l2,
        seed=args.fix_seed if args.fix_seed != -1 else 0,
        rebuild_data=lambda: load_device_data(config, device),
    )

    if args.save_predictions:
        dump_artifacts(config, exp_name, best_acc, model_info, txt=True)
        if job_fp is not None:
            mark_job_complete(config, exp_name, job_fp, best_acc, model_info)
    _maybe_submit(args, config, model_info)
    logging.info("=> Finished: best %s = %.3f", config.TEST.METRIC or "accuracy", best_acc)
    return best_acc, model_info


def _maybe_submit(args, config, model_info):
    """Validate the submission under --submit-predictions; nothing is sent."""
    if not args.submit_predictions:
        return
    from .prediction_submission import submit_predictions

    submission = {
        "model_name": config.MODEL.NAME,
        "dataset_name": config.DATASET.DATASET,
        "n_shot": config.DATASET.NUM_SAMPLES_PER_CLASS,
        "rnd_seeds": [config.DATASET.RANDOM_SEED_SAMPLING],
        "predictions": [model_info["best_logits"].tolist()]
        if model_info.get("best_logits") is not None
        else [],
        "num_trainable_params": model_info.get("n_trainable_params"),
    }
    submit_predictions(submission, args.submit_by, config)
