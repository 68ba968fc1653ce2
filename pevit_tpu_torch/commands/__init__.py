"""Command-line entry points of the port (``python -m
pevit_tpu_torch.commands.<name>``): the PEFT tracks
``kronecker_adaptation_clip``, ``lora_clip``, ``adapter_clip`` and
``compacter_clip``; ``linear_probe``, ``finetune`` and ``zeroshot``; and
``prepare_submit``."""
