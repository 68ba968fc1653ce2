"""Weight-only int8 quantization for serving artifacts.

Counterpart of ``pevit_tpu/quant.py``.  Symmetric per-channel int8: every
large float weight W is stored as

    {"_q8": int8 round(W / s), "scale": s}     s = amax(|W|, axis -2) / 127

with the scale taken over the contraction axis -2 of ``x @ W`` and
dequantized in float32, ``q.float() * s``, before any cast to the compute
dtype.

The reference decides and scales on its own leaves, which stack a tower's
layers on a leading axis; the port holds one tensor a layer.  So
:func:`quantize_tree` restacks each layered leaf first
(``bridge.stacked_layer_axes`` names them) and applies the reference's rule
to the stacked leaf: LoRA's (12, 768, 4) factors are quantized although one
layer's (768, 4) is below ``MIN_SIZE``, and a stacked (L, C) bias with
L >= 16 is scaled over its layer axis, as the reference scales it.  The
int8 values and scales are then bit-equal to the reference's, one layer's
slice each: a scale of shape (1, out) a layer where the reference's is
(L, 1, out), or the shared (out,) row where the layer axis is the
contraction axis.
"""

from __future__ import annotations

import torch

from .bridge import stacked_layer_axes

__all__ = ["QUANT_KEY", "MIN_SIZE", "quantize_tree", "dequantize_tree", "is_quantized",
           "tree_nbytes"]

QUANT_KEY = "_q8"
# below this element count a leaf stays float: biases, LN affines, tiny heads
MIN_SIZE = 16384


def _is_qleaf(node) -> bool:
    return isinstance(node, dict) and QUANT_KEY in node


def _leaves(tree):
    """Every tensor of a nested dict (None skipped), quantized leaves'
    int8 values and scales included."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def is_quantized(tree) -> bool:
    if _is_qleaf(tree):
        return True
    return isinstance(tree, dict) and any(is_quantized(v) for v in tree.values())


def _quantize(leaf: torch.Tensor, min_size: int):
    """The reference's rule on one (stacked) leaf: (int8, scale) or None."""
    if (not leaf.is_floating_point() or leaf.dim() < 2 or leaf.numel() < min_size
            or leaf.shape[-2] < 16):  # the scale overhead would exceed the savings
        return None
    w = leaf.float()
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale


def _layer_key(name: str) -> tuple:
    """(the reference's leaf name, layer index) of a port parameter name;
    the index is None for a leaf the reference does not stack."""
    if not stacked_layer_axes(name):
        return name, None
    parts = name.split(".")
    i = next(k for k, p in enumerate(parts) if p.isdigit())
    return ".".join(parts[:i] + parts[i + 1:]), int(parts[i])


def quantize_tree(weights: dict, *, min_size: int = MIN_SIZE) -> dict:
    """``{dotted name: tensor}`` (a bundle's parameters, one tensor a layer)
    -> the same keys with every large floating leaf as ``{"_q8": int8,
    "scale": float32}``, decided and scaled on the reference's stacked
    leaf; the rest pass through detached."""
    groups: dict = {}
    for name in weights:
        ref, layer = _layer_key(name)
        groups.setdefault(ref, []).append((layer, name))
    out = {}
    for ref, members in groups.items():
        members.sort(key=lambda m: -1 if m[0] is None else m[0])
        layered = members[0][0] is not None
        leaf = (torch.stack([weights[n].detach() for _, n in members]) if layered
                else weights[members[0][1]].detach())
        q = _quantize(leaf, min_size)
        for i, (_, name) in enumerate(members):
            if q is None:
                out[name] = weights[name].detach()
            elif not layered:
                out[name] = {QUANT_KEY: q[0], "scale": q[1]}
            else:
                # a stacked (L, C) leaf is scaled over its layer axis: one
                # (C,) scale row that every layer shares
                scale = q[1][0] if leaf.dim() == 2 else q[1][i]
                out[name] = {QUANT_KEY: q[0][i], "scale": scale}
    return {name: out[name] for name in weights}


def dequantize_tree(tree, dtype=None):
    """The inverse on a nested dict: each quantized leaf as
    ``q.float() * scale`` (then cast to ``dtype`` if given); every other
    leaf passes through."""
    if _is_qleaf(tree):
        w = tree[QUANT_KEY].float() * tree["scale"]
        return w if dtype is None else w.to(dtype)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    return tree


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a nested dict (int8 values and scales of a
    quantized leaf included)."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))
