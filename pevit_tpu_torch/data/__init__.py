from .transforms import CLIP_MEAN, CLIP_STD

__all__ = ["CLIP_MEAN", "CLIP_STD"]
