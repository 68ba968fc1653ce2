from .metrics import (
    accuracy,
    balanced_accuracy_score,
    get_metric,
    map_11_points,
    roc_auc,
)

__all__ = ["accuracy", "balanced_accuracy_score", "get_metric", "map_11_points", "roc_auc"]
