"""CLI: linear probing of the frozen CLIP tower, on the card.

Counterpart of ``pevit_tpu/commands/linear_probe.py`` (reference
vision_benchmark/commands/linear_probe.py, with ``--emulate-zeroshot``,
:69-76), e.g.

    python -m pevit_tpu_torch.commands.linear_probe \\
        --ds resources/datasets/cifar10.yaml --model resources/model/vitb32_CLIP.yaml \\
        --no-tuning True --lr 0.01 --l2 0.0001 DATASET.NUM_SAMPLES_PER_CLASS 5 \\
        MODEL.PRETRAINED random

runs on the CUDA card unless ``--device cpu`` is given.
"""

from ._common import run_training_command


def main(argv=None):
    return run_training_command("linear_probe",
                                description="Test a classification model, with linear probing.",
                                probe=True, argv=argv)


if __name__ == "__main__":
    main()
