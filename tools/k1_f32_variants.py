#!/usr/bin/env python
"""K1's float32 persistent body against copies of its source with a design
choice changed, timed in turns on one CUDA card.

    python3 tools/k1_f32_variants.py SPEC.json

SPEC holds ``variants`` ({label: {"consts": {NAME: VALUE}, "edits": [[old
text, new text], ...]}}: each a copy of this tree's ``ops/csrc`` with
``constexpr`` constants of ``attention_fwd.cu`` set otherwise and texts
replaced, every one of which must stand there; an empty variant is the
source as it is), ``shapes`` ([[B, N, H, hd], ...], float32) and, where
given, ``against`` (a directory holding another ``attention_fwd.cu`` and its
headers, e.g. the parent's ``csrc`` unpacked by ``git archive``, timed as
``against``).  Every version is built by ``nvcc`` (ptxas's spills and
C75xx notes of ``attention_fwd_f32_tma`` printed), held to the plain
version (``attention_ref``) at phase 3's float32 tolerance (rtol 1e-4, atol
1e-5; a variant that computes something else is reported, not refused) and
timed by ``attention_bodies.device_ms`` in turns (every version, then in
reverse; the mean of its two turns).  One JSON line a shape, the card's
name and power limit first.  It needs a CUDA card and exits non-zero
without one.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def variant_source(tmp: Path, label: str, consts: dict, edits: list) -> Path:
    """A copy of this tree's csrc under ``tmp / label`` with ``consts`` set
    and ``edits`` made in ``attention_fwd.cu``; returns the source."""
    from pevit_tpu_torch.ops._build import CSRC

    shutil.copytree(CSRC, tmp / label)
    src = tmp / label / "attention_fwd.cu"
    text = src.read_text()
    for name, value in consts.items():
        pattern = re.compile(rf"constexpr (int|bool) {name} = [^;]+;")
        if len(pattern.findall(text)) != 1:
            raise SystemExit(f"{label}: attention_fwd.cu does not set the constexpr {name} once")
        text = pattern.sub(lambda m: f"constexpr {m.group(1)} {name} = {value};", text)
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{label}: attention_fwd.cu no longer holds {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return src


def main(argv) -> int:
    import torch

    if len(argv) != 1:
        raise SystemExit(__doc__.split("\n\n")[1])
    if not torch.cuda.is_available():
        print("k1_f32_variants: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pevit_tpu_torch.ops import attention
    from pevit_tpu_torch.ops._build import Kernel, _finish
    from pevit_tpu_torch.ops.attention import attention_fwd, attention_ref
    from pevit_tpu_torch.tools.attention_bodies import device_ms, launching

    spec = json.loads(Path(argv[0]).read_text())
    print(cs.card_line(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="k1_f32_variants_"))
    kernel = lambda src: Kernel("attention_fwd", str(src), attention.KERNEL.argtypes,
                                replaces=attention.KERNEL.replaces)
    versions = {label: kernel(variant_source(tmp, label, v.get("consts", {}), v.get("edits", [])))
                for label, v in spec["variants"].items()}
    if spec.get("against"):
        versions["against"] = kernel(Path(spec["against"]).resolve() / "attention_fwd.cu")
    builds = {label: k.start_build() for label, k in versions.items()}
    for label, build in builds.items():
        log = _finish(build) or versions[label].library_path().with_suffix(".log").read_text()
        for line in cs.ptxas_summary("attention_fwd", log):
            if "f32_tma" in line:
                print(f"{label} {line}", flush=True)
        for line in log.splitlines():
            if "C75" in line or "serializ" in line:
                print(f"{label} NOTE {line.strip()[:300]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = lambda x: x.transpose(1, 2)
    for B, n, H, hd in spec["shapes"]:
        qk = (0.25 / hd) ** 0.25
        q, k, v = (torch.randn(B, n, H, hd, device="cuda", generator=gen) * s
                   for s in (qk, qk, 1.0))
        want = t(attention_ref(t(q), t(k), t(v)))
        row = {"shape": [B, n, H, hd]}
        for label, kern in versions.items():
            with launching(kern):
                got = attention_fwd(q, k, v)
            torch.cuda.synchronize()
            row[f"{label}_close"] = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-5))
        turns = {label: [] for label in versions}
        for label in list(versions) + list(versions)[::-1]:
            with launching(versions[label]):
                turns[label].append(device_ms(lambda: attention_fwd(q, k, v)))
        row.update({f"{label}_ms": statistics.mean(ms) for label, ms in turns.items()})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
