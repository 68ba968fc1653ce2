"""Host-side image preprocessing: PIL-bicubic resize + center crop, and
CLIP's per-channel normalisation constants (RGB, on [0, 1] pixels).

Counterpart of ``pevit_tpu/data/transforms.py``: the reference pipeline
(feature.py:534-549) is Resize(224, bicubic) -> CenterCrop(224) -> ToTensor
-> Normalize; resize and crop run on the host, the output stays uint8, and
the normalisation runs on the card.  An RGB uint8 array goes through the
C++ PIL-compatible resampler (``pevit_tpu_torch.native``), where the
reference takes it; everything else goes through PIL, imported inside the
functions, since the card's Python lacks it.  Unlike the reference, a
native build that fails raises instead of falling back to PIL.
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_center_crop(img, size: int = 224, *, use_native: bool = True) -> np.ndarray:
    """torchvision Resize(size) + CenterCrop(size); returns uint8 HWC.  An
    (H, W, 3) uint8 array takes the native resampler unless ``use_native``
    is False."""
    if use_native and isinstance(img, np.ndarray) and img.ndim == 3 and img.shape[2] == 3:
        from ..native import native_resize_center_crop

        return native_resize_center_crop(img, size)
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img = img.convert("RGB")
    w, h = img.size
    # torchvision Resize(int): the SHORTER side goes to `size`, the long side
    # truncates (torchvision functional.resize int() semantics)
    if w <= h:
        new_w, new_h = size, max(size, int(h * size / w))
    else:
        new_w, new_h = max(size, int(w * size / h)), size
    img = img.resize((new_w, new_h), Image.BICUBIC)
    left = int(round((new_w - size) / 2.0))
    top = int(round((new_h - size) / 2.0))
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img, dtype=np.uint8)


def resize_exact(img, size: int = 224) -> np.ndarray:
    """torchvision Resize((size, size), bicubic), no crop: the reference's
    ``DATASET.CENTER_CROP False`` branch (feature.py:543-549)."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img = img.convert("RGB")
    return np.asarray(img.resize((size, size), Image.BICUBIC), dtype=np.uint8)


def preprocess_batch(images, size: int = 224, *, center_crop: bool = True) -> np.ndarray:
    """List of PIL/ndarray images -> (N, size, size, 3) uint8."""
    fn = resize_center_crop if center_crop else resize_exact
    return np.stack([fn(im, size) for im in images])
