"""CLIP's per-channel normalisation constants (RGB, on [0, 1] pixels)."""

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
