"""CLI: the bottleneck adapter after each MLP on CLIP, on the card.

Counterpart of ``pevit_tpu/commands/adapter_clip.py`` (reference
vision_benchmark/commands/adapter_clip.py), e.g.

    python -m pevit_tpu_torch.commands.adapter_clip \\
        --ds resources/datasets/cifar10.yaml --model resources/model/vitb32_CLIP.yaml \\
        --no-tuning False DATASET.NUM_SAMPLES_PER_CLASS 5 \\
        TRAIN.INIT_HEAD_WITH_TEXT_ENCODER True MODEL.PRETRAINED random

runs on the CUDA card unless ``--device cpu`` is given.
"""

from ._common import run_training_command


def main(argv=None):
    return run_training_command("adapter", description="Test a classification model, with finetuning.", argv=argv)


if __name__ == "__main__":
    main()
