from .metrics import (
    accuracy,
    balanced_accuracy_score,
    get_metric,
    map_11_points,
    roc_auc,
)
from .text_features import build_prompts, extract_text_features
from .zeroshot import clip_zeroshot_evaluator, extract_image_features

__all__ = ["accuracy", "balanced_accuracy_score", "build_prompts", "clip_zeroshot_evaluator",
           "extract_image_features", "extract_text_features", "get_metric", "map_11_points",
           "roc_auc"]
