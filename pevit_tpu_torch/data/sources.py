"""Dataset sources: in-memory datasets from local storage (no network).

A copy of ``pevit_tpu/data/sources.py`` (the port imports nothing of the
JAX package).  PIL is imported only inside the functions that decode
images (ImageFolder, manifest, CIFAR), since the card's Python lacks it; the
``.npz`` fast path and the synthetic source need numpy only.

The reference streams ELEVATER datasets from an Azure blob through the
``vision_datasets`` package (feature.py:551-598) and falls back to
torchvision ImageFolder (feature.py:599-607).  The port reads no network
and needs no torchvision, so sources resolve locally, in order:

1. a preprocessed ``.npz`` cache (``{split}.npz`` with images uint8 + labels)
   — the fast path the loader itself writes,
2. CIFAR-10/100 python-pickle batches if present under DATASET.ROOT,
3. an ImageFolder tree (``root/{split}/{class_name}/*.jpg``) decoded with PIL,
4. an ELEVATER-style ``{split}.json`` manifest (images list with file paths
   + label ids) next to the images,
5. a deterministic synthetic dataset (smoke tests / benchmarks) when the
   dataset name starts with ``synthetic`` or nothing else resolves and
   ``allow_synthetic`` is set.

Few-shot subsetting and the class-balanced val split happen in
``build_splits`` with reference-exact semantics (see sampling.py).
"""

from __future__ import annotations

import json
import logging
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from .registry import get_dataset_info
from .sampling import class_balanced_val_split, sample_few_shot_subset
from .transforms import preprocess_batch, resize_center_crop, resize_exact


@dataclass
class ArrayDataset:
    """The in-memory dataset unit: uint8 images + labels."""

    images: np.ndarray  # (N, H, W, 3) uint8
    labels: np.ndarray  # (N,) int64 or (N, C) float32 multihot

    def __len__(self):
        return len(self.labels)

    def subset(self, idx) -> "ArrayDataset":
        idx = np.asarray(idx)
        return ArrayDataset(self.images[idx], self.labels[idx])


# ---------------------------------------------------------------------------
# individual source loaders
# ---------------------------------------------------------------------------

def _load_npz(root: Path, split: str) -> Optional[ArrayDataset]:
    f = root / f"{split}.npz"
    if not f.exists():
        return None
    z = np.load(f)
    return ArrayDataset(z["images"], z["labels"])


# ---------------------------------------------------------------------------
# sharded decode cache: full-shot datasets (hundreds of thousands of images)
# take hours to decode on a host with few cores — the decode must be a RESUMABLE
# one-time cost.  Shards of _DECODE_SHARD_SIZE entries are written as they
# complete (``{split}.shardNNNNN.npz`` + a ``{split}.cache.json`` index);
# an interrupted run picks up at the first undecoded entry.  After the full
# decode, load_split consolidates into the single-file ``{split}.npz`` fast
# path and removes the shards.
# ---------------------------------------------------------------------------

_DECODE_SHARD_SIZE = 2048


def _load_shard_cache(root: Path, split: str) -> Optional[ArrayDataset]:
    idx_f = root / f"{split}.cache.json"
    if not idx_f.exists():
        return None
    try:
        meta = json.loads(idx_f.read_text())
    except (json.JSONDecodeError, OSError):
        return None
    if not meta.get("complete"):
        return None
    xs, ys = [], []
    for i in range(meta["n_shards"]):
        z = np.load(root / f"{split}.shard{i:05d}.npz")
        if len(z["labels"]):
            xs.append(z["images"])
            ys.append(z["labels"])
    if not xs:
        return None
    return ArrayDataset(np.concatenate(xs), np.concatenate(ys))


def _decode_with_shard_cache(root: Path, split: str, image_size: int, entries, decode_one):
    """Decode ``entries`` through ``decode_one(entry) -> (img|None, label)``
    with per-shard incremental caching, progress + ETA logging, and resume."""
    import time

    root.mkdir(parents=True, exist_ok=True)
    idx_f = root / f"{split}.cache.json"
    S = _DECODE_SHARD_SIZE
    meta = {"complete": False, "n_shards": 0, "entries_done": 0,
            "image_size": image_size, "shard_size": S, "total": len(entries)}
    if idx_f.exists():
        try:
            m = json.loads(idx_f.read_text())
            if (m.get("image_size"), m.get("shard_size"), m.get("total")) == (image_size, S, len(entries)):
                meta = m
        except (json.JSONDecodeError, OSError):
            pass
    if meta.get("complete"):
        return _load_shard_cache(root, split)

    start = meta["entries_done"]
    if start:
        logging.info("%s: resuming decode at entry %d/%d (%d shards cached)",
                     split, start, len(entries), meta["n_shards"])
    t0 = time.time()
    pos = start
    while pos < len(entries):
        chunk = entries[pos : pos + S]
        xs, ys = [], []
        for e in chunk:
            img, label = decode_one(e)
            if img is not None:
                xs.append(img)
                ys.append(label)
        shard_i = meta["n_shards"]
        np.savez_compressed(
            root / f"{split}.shard{shard_i:05d}.npz",
            images=np.stack(xs) if xs else np.zeros((0, image_size, image_size, 3), np.uint8),
            labels=np.asarray(ys) if ys else np.zeros((0,), np.int64),
        )
        pos += len(chunk)
        meta["n_shards"] = shard_i + 1
        meta["entries_done"] = pos
        idx_f.write_text(json.dumps(meta))
        rate = (pos - start) / max(time.time() - t0, 1e-9)
        logging.info("decode %s: %d/%d entries (shard %d done, %.1f img/s, ETA %.0fs)",
                     split, pos, len(entries), shard_i, rate,
                     (len(entries) - pos) / max(rate, 1e-9))
    meta["complete"] = True
    idx_f.write_text(json.dumps(meta))
    return _load_shard_cache(root, split)


def _drop_shard_cache(root: Path, split: str) -> None:
    """Remove shard files once the consolidated {split}.npz exists."""
    idx_f = root / f"{split}.cache.json"
    if not idx_f.exists():
        return
    try:
        meta = json.loads(idx_f.read_text())
        for i in range(meta.get("n_shards", 0)):
            (root / f"{split}.shard{i:05d}.npz").unlink(missing_ok=True)
        idx_f.unlink(missing_ok=True)
    except (json.JSONDecodeError, OSError):
        pass


_CIFAR10_FILES = {
    "train": [f"data_batch_{i}" for i in range(1, 6)],
    "test": ["test_batch"],
}


def _load_cifar(root: Path, split: str, image_size: int) -> Optional[ArrayDataset]:
    # CIFAR-10 python version layout
    base10 = root / "cifar-10-batches-py"
    base100 = root / "cifar-100-python"
    if base10.exists():
        files = _CIFAR10_FILES["train" if split == "train" else "test"]
        xs, ys = [], []
        for fn in files:
            with open(base10 / fn, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    elif base100.exists():
        fn = "train" if split == "train" else "test"
        with open(base100 / fn, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        ys = d[b"fine_labels"]
    else:
        return None
    logging.info("Resizing %d CIFAR images to %d (bicubic, native)...", len(x), image_size)
    images = preprocess_batch(list(x), image_size)
    return ArrayDataset(images, np.asarray(ys, np.int64))


def _load_imagefolder(
    root: Path, split: str, image_size: int,
    *, center_crop: bool = True, dir_names: Optional[list] = None,
) -> Optional[ArrayDataset]:
    """``dir_names``: physical directory candidates for this logical split —
    the reference's ImageFolder path joins ROOT with DATASET.TRAIN_SET /
    VAL_SET / TEST_SET (feature.py:601-607); the logical name is kept as a
    fallback so existing trees keep loading."""
    d = None
    for cand in dir_names or [split]:
        if cand and (root / cand).is_dir():
            d = root / cand
            break
    if d is None:
        return None
    classes = sorted(p.name for p in d.iterdir() if p.is_dir())
    if not classes:
        return None
    from PIL import Image

    entries = []
    for ci, cname in enumerate(classes):
        for f in sorted((d / cname).iterdir()):
            if f.suffix.lower() in (".jpg", ".jpeg", ".png", ".bmp", ".webp"):
                entries.append((f, ci))
    if not entries:
        return None

    resize = resize_center_crop if center_crop else resize_exact

    def decode_one(entry):
        f, ci = entry
        try:
            with Image.open(f) as im:
                return resize(im, image_size), np.int64(ci)
        except Exception as e:  # corrupt images tolerated (feature.py:47-49)
            logging.warning("skipping corrupt image %s: %s", f, e)
            return None, None

    cache_key = split if center_crop else f"{split}.nocrop"
    return _decode_with_shard_cache(root, cache_key, image_size, entries, decode_one)


def _load_manifest(root: Path, split: str, image_size: int, num_classes: int,
                   *, center_crop: bool = True) -> Optional[ArrayDataset]:
    f = root / f"{split}.json"
    if not f.exists():
        return None
    manifest = json.loads(f.read_text())
    from PIL import Image

    entries = manifest["images"]
    multilabel = any(isinstance(e.get("labels"), list) and len(e["labels"]) != 1 for e in entries)
    resize = resize_center_crop if center_crop else resize_exact

    def decode_one(e):
        with Image.open(root / e["path"]) as im:
            img = resize(im, image_size)
        labels = e["labels"] if isinstance(e["labels"], list) else [e["labels"]]
        if multilabel:
            vec = np.zeros(num_classes, np.float32)
            vec[np.asarray(labels, int)] = 1.0
            return img, vec
        return img, np.int64(labels[0])

    cache_key = split if center_crop else f"{split}.nocrop"
    return _decode_with_shard_cache(root, cache_key, image_size, entries, decode_one)


def _synthetic(name: str, split: str, image_size: int, num_classes: int) -> ArrayDataset:
    """Deterministic class-separable synthetic data (tests/benchmarks).

    Class prototypes are seeded from the dataset NAME only so train/val/test
    share the same class->colour mapping (a model trained on the train split
    must generalise to the test split); per-split noise differs.
    """
    import zlib

    from .registry import MULTILABEL_DATASETS

    name_seed = zlib.crc32(name.encode()) % (2**31)
    split_seed = zlib.crc32(f"{name}/{split}".encode()) % (2**31)
    base = np.random.default_rng(name_seed).integers(30, 225, (max(num_classes, 1), 3))
    rng = np.random.default_rng(split_seed)
    n = {"train": 32 * max(2, num_classes), "val": 8 * max(2, num_classes), "test": 16 * max(2, num_classes)}[split]
    ys = rng.integers(0, max(num_classes, 1), n)
    imgs = base[ys][:, None, None, :] + rng.normal(0, 30, (n, image_size, image_size, 3))
    if name in MULTILABEL_DATASETS:
        # voc-2007-shaped synthetic data: binary (N, C) labels — the primary
        # class plus an occasional second positive, whose prototype colour is
        # blended into the image so BCE training has signal for both.
        C = max(num_classes, 2)
        y_mat = np.zeros((n, C), np.int64)
        y_mat[np.arange(n), ys] = 1
        extra = rng.integers(0, C, n)
        has_extra = (rng.random(n) < 0.3) & (extra != ys)
        y_mat[np.arange(n)[has_extra], extra[has_extra]] = 1
        imgs[has_extra] = 0.5 * imgs[has_extra] + 0.5 * (
            base[extra[has_extra]][:, None, None, :]
            + rng.normal(0, 30, (int(has_extra.sum()), image_size, image_size, 3))
        )
        return ArrayDataset(np.clip(imgs, 0, 255).astype(np.uint8), y_mat)
    return ArrayDataset(np.clip(imgs, 0, 255).astype(np.uint8), ys.astype(np.int64))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def load_split(
    name: str,
    root: str,
    split: str,
    *,
    image_size: int = 224,
    num_classes: int = 0,
    allow_synthetic: bool = True,
    cache: bool = True,
    center_crop: bool = True,
    dir_names: Optional[list] = None,
) -> ArrayDataset:
    """``center_crop``: DATASET.CENTER_CROP — off = exact (size, size) resize
    (feature.py:543-549); off runs cache under ``{split}.nocrop.*`` so the two
    preprocessing modes never read each other's artifacts.  ``dir_names``:
    physical ImageFolder dir candidates (DATASET.TRAIN_SET etc.)."""
    rootp = Path(root) if root else Path(".")
    cache_key = split if center_crop else f"{split}.nocrop"
    ds = _load_npz(rootp, cache_key)
    if ds is None:
        ds = _load_shard_cache(rootp, cache_key)  # completed decode, unconsolidated
    if ds is None and name.startswith("cifar"):
        # square source images: shorter-side resize + crop == exact resize
        ds = _load_cifar(rootp, split, image_size)
    if ds is None:
        ds = _load_imagefolder(rootp, split, image_size,
                               center_crop=center_crop, dir_names=dir_names)
    if ds is None:
        ds = _load_manifest(rootp, split, image_size, num_classes,
                            center_crop=center_crop)
    if ds is None:
        if not (allow_synthetic or name.startswith("synthetic")):
            raise FileNotFoundError(f"No local data for dataset {name!r} under {root!r}")
        logging.warning("dataset %s not found under %s; using synthetic data", name, root)
        ds = _synthetic(name, split, image_size, num_classes)
    elif cache and not (rootp / f"{cache_key}.npz").exists():
        try:
            rootp.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(rootp / f"{cache_key}.npz", images=ds.images, labels=ds.labels)
            _drop_shard_cache(rootp, cache_key)  # shards superseded by the npz
        except OSError:
            pass
    return ds


def build_splits(config, *, test_split_only: bool = False):
    """construct_dataloader equivalent (feature.py:534-609): returns
    (train, val, test) ArrayDatasets with few-shot subset + 0.2 val split.

    A REAL (ELEVATER-registered) dataset name with no resolvable local data
    fails loudly, like the reference's Azure hub does (feature.py:556-560) —
    silently training on synthetic colours would produce plausible-looking
    but meaningless artifacts.  ``DATASET.ALLOW_SYNTHETIC True`` (what the
    smoke grid sets) or a ``synthetic*`` name opts back in."""
    name = config.DATASET.DATASET
    info = get_dataset_info(name)
    num_classes = config.DATASET.NUM_CLASSES or info.num_classes
    image_size = config.TRAIN.IMAGE_SIZE[0]
    root = config.DATASET.ROOT
    from .registry import ELEVATER_DATASETS

    allow_syn = (
        bool(config.DATASET.get("ALLOW_SYNTHETIC", False))
        or name.startswith("synthetic")
        or name not in ELEVATER_DATASETS
    )

    # DATASET.CENTER_CROP (feature.py:535-549) + physical split dir names for
    # ImageFolder trees (feature.py:601-607); the logical name stays as a
    # fallback candidate so existing local trees keep resolving
    center_crop = bool(config.DATASET.CENTER_CROP)
    if not center_crop:
        logging.info("no center crop")
    common = dict(image_size=image_size, num_classes=num_classes,
                  allow_synthetic=allow_syn, center_crop=center_crop)

    def dirs(configured: str, logical: str) -> list:
        # logical name first (this loader's documented tree layout), the
        # configured reference name (TRAIN_SET/VAL_SET/TEST_SET) as the
        # fallback — so ImageNet-style trees (test images in ``val/``,
        # the reference's TEST_SET default) resolve without renames
        return [logical, configured] if configured and configured != logical else [logical]

    test = load_split(name, root, "test",
                      dir_names=dirs(config.DATASET.TEST_SET, "test"), **common)
    if test_split_only:
        return None, None, test

    # train split may live in 'train' (+optional separate val dir)
    full_train = load_split(name, root, "train",
                            dir_names=dirs(config.DATASET.TRAIN_SET, "train"), **common)

    n_shot = config.DATASET.NUM_SAMPLES_PER_CLASS
    if n_shot > 0:
        idx = sample_few_shot_subset(full_train.labels, n_shot, config.DATASET.RANDOM_SEED_SAMPLING)
        full_train = full_train.subset(idx)
        logging.info("few-shot subset: %d-shot seed %d -> %d images",
                     n_shot, config.DATASET.RANDOM_SEED_SAMPLING, len(full_train))

    if config.DATASET.VAL_SET:
        # explicit val directory: the whole train set trains, no 0.2 carve-out
        # (feature.py:601-603)
        val = load_split(name, root, "val",
                         dir_names=dirs(config.DATASET.VAL_SET, "val"), **common)
        train = full_train
    else:
        train_idx, val_idx = class_balanced_val_split(full_train.labels, val_split=0.2)
        train, val = full_train.subset(train_idx), full_train.subset(val_idx)
    logging.info("splits: train=%d val=%d test=%d", len(train), len(val), len(test))
    return train, val, test
