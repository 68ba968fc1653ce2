"""PyTorch/CUDA port of pevit_tpu for one NVIDIA H100.

The JAX package ``pevit_tpu`` is the reference this port is held against; the
port imports nothing of it and never imports JAX.  Module names mirror the
reference so each counterpart is easy to find.  Slice 1 covers the serving
path: a KAdaptation-tuned CLIP ViT classifier, uint8 images in, logits out,
with the attention core and the fused residual MLP as hand-written CUDA
kernels (``ops/csrc``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
device on a host without CUDA they raise (``utils.device.resolve_device``).
"""
