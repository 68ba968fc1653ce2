"""Leaderboard submission validation.

Counterpart of ``pevit_tpu/commands/prediction_submission.py`` (reference
common/prediction_submission.py: the track and task names, :13-43, and the
probability-simplex and shape checks on the predictions, :55-88, with
common/utils.py's submit_predictions).  As in the reference, a submission
is validated and logged; nothing is sent over the network, so the
``prepare_submit`` zip is uploaded by hand.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np

TRACKS = {
    "linear_probing": "Linear Probing",
    "finetuning": "Fine-tuning",
    "zero_shot": "Zero-shot",
    "parameter_efficiency": "Parameter-Efficiency",
}
TASKS = {"image_classification_20_datasets", "image_classification"}


@dataclasses.dataclass
class PredictionSubmission:
    model_name: str
    dataset_name: str
    n_shot: int
    rnd_seeds: List[int]
    predictions: List  # per-seed (N, C) probability matrices
    num_trainable_params: Optional[float] = None
    num_params: Optional[int] = None
    num_visual_params: Optional[int] = None
    num_backbone_params: Optional[int] = None
    track: str = "parameter_efficiency"
    task: str = "image_classification"

    @classmethod
    def from_dict(cls, d: dict) -> "PredictionSubmission":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def validate(self, *, atol: float = 1e-3) -> None:
        """Raises ValueError on an invalid submission (reference :55-88)."""
        if self.track not in TRACKS:
            raise ValueError(f"unknown track {self.track!r}; expected one of {sorted(TRACKS)}")
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r}")
        if not self.rnd_seeds or len(self.rnd_seeds) != len(self.predictions):
            raise ValueError(
                f"rnd_seeds ({len(self.rnd_seeds)}) and predictions "
                f"({len(self.predictions)}) must align and be non-empty"
            )
        for i, pred in enumerate(self.predictions):
            p = np.asarray(pred, dtype=np.float64)
            if p.ndim != 2:
                raise ValueError(f"predictions[{i}] must be (N, C); got shape {p.shape}")
            if np.any(p < -atol) or np.any(p > 1 + atol):
                raise ValueError(f"predictions[{i}] outside [0, 1]")
            sums = p.sum(axis=1)
            if not np.allclose(sums, 1.0, atol=atol):
                raise ValueError(
                    f"predictions[{i}] rows are not a probability simplex "
                    f"(row sums in [{sums.min():.4f}, {sums.max():.4f}])"
                )


def validate_submission_dict(d: dict) -> PredictionSubmission:
    sub = PredictionSubmission.from_dict(d)
    sub.validate()
    return sub


def model_info_from_config(config) -> dict:
    """The leaderboard model record (reference common/utils.py:29-37), from
    MODEL.AUTHOR / NUM_PARAMS_IN_M / PRETRAINED_DATA / CREATION_TIME."""
    return {
        "name": config.MODEL.NAME,
        "author": config.MODEL.AUTHOR,
        "num_params_in_millions": config.MODEL.NUM_PARAMS_IN_M,
        "pretrained_data": config.MODEL.PRETRAINED_DATA,
        "creation_time": config.MODEL.CREATION_TIME,
    }


def submit_predictions(submission: dict, submit_by: str, config) -> None:
    """Validate ``submission`` (raising ValueError if it is invalid) and log
    the model record and what would be submitted."""
    sub = validate_submission_dict(submission)
    logging.info("model record: %s", model_info_from_config(config))
    logging.info(
        "submission valid: %s on %s (%d seeds) by %s; nothing is sent: upload the "
        "prepare_submit zip by hand",
        sub.model_name, sub.dataset_name, len(sub.rnd_seeds), submit_by,
    )
