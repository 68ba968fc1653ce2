"""Backbone plugin templates.

Counterpart of ``pevit_tpu/models/examples.py`` (reference
models/cls_example.py and models/clip_example.py): the plugin contract for
adding a backbone is the ``Backbone`` of ``factory.py``, a parameter module
and forward functions on tensors.

A classifier plugin (``cls_example``)::

    def get_cls_model(config, device=None) -> Backbone:
        params = ...            # an nn.Module
        def forward_features(params, images, use_fused_mlp=True):
            ...                 # (B, H, W, 3) float -> (B, D)
        return Backbone(name="my_model", params=params, feat_dim=D,
                        forward_features=forward_features)

A dual-tower plugin (``clip_example``) also sets ``encode_text(params,
tokens) -> (B, D)``, which makes it usable for zero-shot evaluation and
text-initialised heads.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.device import resolve_device
from .factory import Backbone


def get_cls_example(config, device=None) -> Backbone:
    """A minimal working classifier plugin (random projection features)."""
    dim = 64
    size = config.TRAIN.IMAGE_SIZE[0]
    gen = torch.Generator().manual_seed(0)
    params = nn.Module()
    params.proj = nn.Parameter(0.02 * torch.randn(size * size * 3, dim, generator=gen))

    def forward_features(p, x, use_fused_mlp=True):
        return x.reshape(x.shape[0], -1).float() @ p.proj

    return Backbone(name="cls_example", params=params.to(resolve_device(device)), feat_dim=dim,
                    forward_features=forward_features)


def get_clip_example(config, device=None) -> Backbone:
    """A minimal working dual-tower plugin."""
    dim = 64
    size = config.TRAIN.IMAGE_SIZE[0]
    gen = torch.Generator().manual_seed(0)
    params = nn.Module()
    params.img_proj = nn.Parameter(0.02 * torch.randn(size * size * 3, dim, generator=gen))
    params.tok_embed = nn.Parameter(0.02 * torch.randn(49408, dim, generator=gen))

    def forward_features(p, x, use_fused_mlp=True):
        return x.reshape(x.shape[0], -1).float() @ p.img_proj

    def encode_text(p, tokens):
        return p.tok_embed[tokens].mean(dim=1)

    return Backbone(name="clip_example", params=params.to(resolve_device(device)), feat_dim=dim,
                    forward_features=forward_features, encode_text=encode_text)
