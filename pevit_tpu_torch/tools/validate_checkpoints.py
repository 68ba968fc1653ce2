"""Audit a checkpoint's key map with the port's mappers, offline.

Counterpart of ``tools/validate_checkpoints.py``.  The port reads published
checkpoints through its own mappers: ``ckpt.torch_loader`` for the OpenAI
CLIP ViT and RN layouts, and the timm ViT, DeCLIP, Swin and CLIP-Swin
converters of ``models``.  They are built from the reference code's
layouts, and a published checkpoint checks them the day a machine has one:

    python -m pevit_tpu_torch.tools.validate_checkpoints --ckpt DeCLIP_vitb32.pth --family declip

The tool (1) runs the family's mapper, which raises on a missing or
mis-shaped key, and (2) classifies every key of the checkpoint as mapped,
ignored or unexpected with the prefix rules the mappers implement.  It
prints a JSON report.  Exit codes: 0 clean, 1 unexpected keys, 2 the mapper
failed.  ``--family auto`` tells the family from the key set.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np

_COMMON_IGNORE = [
    r".*\.num_batches_tracked$",
    r".*\.attn_mask$",          # buffers the port rebuilds
    r".*relative_position_index$",
]


def _map_clip(sd):
    from ..ckpt.torch_loader import state_dict_to_params

    return state_dict_to_params(sd)


def _map_declip(sd):
    from ..models.declip import declip_state_dict_to_params, normalize_declip_state_dict

    return declip_state_dict_to_params(normalize_declip_state_dict(sd))


def _map_clip_swin(sd):
    from ..models.swin import clip_swin_state_dict_to_params

    return clip_swin_state_dict_to_params(sd)


def _map_swin(sd):
    from ..models.swin import swin_state_dict_to_params

    return swin_state_dict_to_params(sd)


def _map_timm_vit(sd):
    from ..models.vit import timm_state_dict_to_params

    return timm_state_dict_to_params(sd)


def _declip_rules():
    from ..models.declip import _IGNORED_PREFIXES

    mapped = [
        r"visual\..*",
        r"(encode_text|text_encoder)\..*",
        r"logit_scale$",
        r"(image|text)_mapping\.(weight|bias)$",
        r"logit_scale_dense$",
    ]
    return mapped, [re.escape(p) + r".*" for p in _IGNORED_PREFIXES]


# family: (mapper, mapped-key rules, ignored-key rules); a rule is a regex
# matched against the whole key
FAMILIES = {
    "clip": (
        _map_clip,
        [
            r"visual\..*",
            r"transformer\.resblocks\..*",
            r"(token_embedding|ln_final|text_projection|positional_embedding|logit_scale).*",
        ],
        [r"(input_resolution|context_length|vocab_size)$"],  # TorchScript archives' scalars
    ),
    "declip": (_map_declip, None, None),  # the rules read the module's ignored prefixes
    "clip_swin": (
        _map_clip_swin,
        [r"visual\..*", r"text\..*", r"(text_projection|vision_projection|logit_scale)$"],
        [],
    ),
    "swin": (
        _map_swin,
        [r"patch_embed\..*", r"layers\..*", r"norm\.(weight|bias)$", r"head\.(weight|bias)$"],
        [],
    ),
    "timm_vit": (
        _map_timm_vit,
        [
            r"(cls_token|pos_embed|patch_embed\..*)",
            r"blocks\..*",
            r"(norm|fc_norm)\.(weight|bias)$",
            r"head\.(weight|bias)$",
        ],
        [r"mask_token$"],
    ),
}


def sniff_family(keys) -> str:
    """The family a key set belongs to (the reference tool's rules)."""
    ks = set(keys)
    if any(k.startswith(("encode_text.", "text_encoder.")) for k in ks):
        return "declip"
    if "visual.conv1.weight" in ks or "visual.layer1.0.conv1.weight" in ks:
        return "clip"
    if any(k.startswith("visual.patch_embed.") for k in ks):
        return "clip_swin"
    if "patch_embed.proj.weight" in ks:
        return "swin"
    if "cls_token" in ks or "pos_embed" in ks:
        return "timm_vit"
    raise SystemExit(f"--family auto: could not tell the family from keys like {sorted(ks)[:5]}")


def load_state_dict(path: str) -> dict:
    """A ``.npz`` or ``.pt`` / ``.pth`` state dict as numpy arrays."""
    p = Path(path)
    if p.suffix == ".npz":
        z = np.load(p, allow_pickle=False)
        return {k: z[k] for k in z.files}
    from ..ckpt.torch_loader import read_torch_state_dict

    return read_torch_state_dict(str(p))


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_n_leaves(v) for v in tree)
    return int(hasattr(tree, "shape"))


def validate(sd: dict, family: str) -> dict:
    """The mapper's outcome and every key's class; the report dict."""
    mapper, mapped_rules, ignored_rules = FAMILIES[family]
    if family == "declip":
        from ..models.declip import normalize_declip_state_dict

        sd = normalize_declip_state_dict(sd)
        mapped_rules, ignored_rules = _declip_rules()
    arrays = {k: v for k, v in sd.items() if hasattr(v, "shape")}
    report = {"family": family, "n_keys": len(arrays)}
    try:
        params = mapper(sd)[0]
        report["mapper"] = "ok"
        report["n_param_leaves"] = _n_leaves(params)
    except Exception as e:  # noqa: BLE001 - any mapper failure is reported
        report["mapper"] = f"FAILED: {type(e).__name__}: {e}"
        report["n_param_leaves"] = 0
    mapped_re = [re.compile(r) for r in mapped_rules]
    ignored_re = [re.compile(r) for r in list(ignored_rules) + _COMMON_IGNORE]
    mapped, ignored, unexpected = [], [], []
    for k in sorted(arrays):
        if any(r.fullmatch(k) for r in ignored_re):
            ignored.append(k)
        elif any(r.fullmatch(k) for r in mapped_re):
            mapped.append(k)
        else:
            unexpected.append(k)
    report.update(n_mapped=len(mapped), n_ignored=len(ignored), n_unexpected=len(unexpected),
                  unexpected=unexpected[:20], ignored=ignored[:20])
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True, help=".pt/.pth/.npz state dict to audit")
    ap.add_argument("--family", default="auto", choices=["auto", *FAMILIES])
    args = ap.parse_args(argv)

    sd = load_state_dict(args.ckpt)
    family = args.family
    if family == "auto":
        if any(k in ("model", "state_dict") for k in sd):
            from ..models.declip import normalize_declip_state_dict

            sd_keys = normalize_declip_state_dict(sd)
        else:
            sd_keys = sd
        family = sniff_family(sd_keys)
    report = validate(sd, family)
    print(json.dumps(report, indent=2))
    if report["mapper"] != "ok":
        return 2
    return 1 if report["n_unexpected"] else 0


if __name__ == "__main__":
    sys.exit(main())
