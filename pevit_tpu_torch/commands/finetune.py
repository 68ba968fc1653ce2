"""CLI: full fine-tuning of the CLIP visual tower, on the card.

Counterpart of ``pevit_tpu/commands/finetune.py`` (reference
vision_benchmark/commands/finetune.py): the linear probe's trainer with the
visual tower trainable (its MLPs on the plain path, since the fused MLP's
backward gives dx only), e.g.

    python -m pevit_tpu_torch.commands.finetune \\
        --ds resources/datasets/cifar10.yaml --model resources/model/vitb32_CLIP.yaml \\
        --no-tuning True --lr 1e-5 --l2 0.0001 DATASET.NUM_SAMPLES_PER_CLASS 5 \\
        MODEL.PRETRAINED random

runs on the CUDA card unless ``--device cpu`` is given.
"""

from ._common import run_training_command


def main(argv=None):
    return run_training_command("full_finetune",
                                description="Test a classification model, with finetuning.",
                                argv=argv)


if __name__ == "__main__":
    main()
