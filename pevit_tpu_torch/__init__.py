"""PyTorch/CUDA port of pevit_tpu for one NVIDIA H100.

The JAX package ``pevit_tpu`` is the reference this port is held against; the
port imports nothing of it and never imports JAX.  Module names mirror the
reference so each counterpart is easy to find.  It serves a KAdaptation-tuned
CLIP ViT classifier (uint8 images in, logits out) and trains one (the
``train.trainer.TrainTask`` runs), with the attention core, the fused
residual MLP and that MLP's backward as hand-written CUDA kernels
(``ops/csrc``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
device on a host without CUDA they raise (``utils.device.resolve_device``).
"""
