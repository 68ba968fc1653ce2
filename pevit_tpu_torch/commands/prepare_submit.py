"""CLI: merge per-seed prediction JSONs into a leaderboard submission zip.

Counterpart of ``pevit_tpu/commands/prepare_submit.py`` (reference
vision_benchmark/commands/prepare_submit.py:27-68): for each dataset, combine
the per-seed JSONs (the mean of num_trainable_params, rnd_seeds and
predictions chained) and zip them as ``all_predictions.zip``.
"""

from __future__ import annotations

import argparse
import json
import os
import zipfile
from collections import defaultdict

from ..utils import dist as comm
from ._common import json_prec_dump


def combine_seed_files(files: list) -> dict:
    datas = []
    for f in files:
        with open(f) as fh:
            datas.append(json.load(fh))
    combined = dict(datas[0])
    combined["num_trainable_params"] = (
        sum(d.get("num_trainable_params") or 0 for d in datas) / len(datas)
    )
    combined["rnd_seeds"] = [s for d in datas for s in d["rnd_seeds"]]
    combined["predictions"] = [p for d in datas for p in d["predictions"]]
    return combined


def main(argv=None):
    parser = argparse.ArgumentParser(description="Prepare leaderboard submission.")
    parser.add_argument("--combine_path", required=True, type=str,
                        help="Folder holding seed{S}_{dataset}.json prediction files.")
    args = parser.parse_args(argv)
    comm.initialize(device="cpu")  # a host-side tool: gloo in a world, the main rank writes
    if not comm.is_main_process():
        comm.barrier()
        return None

    by_dataset = defaultdict(list)
    for fname in sorted(os.listdir(args.combine_path)):
        if fname.endswith(".json") and fname.startswith("seed"):
            dataset = fname.split("_", 1)[1][: -len(".json")]
            by_dataset[dataset].append(os.path.join(args.combine_path, fname))

    out_zip = os.path.join(args.combine_path, "all_predictions.zip")
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        for dataset, files in sorted(by_dataset.items()):
            zf.writestr(f"{dataset}.json", json_prec_dump(combine_seed_files(files)))
    print(f"wrote {out_zip} with {len(by_dataset)} datasets")
    comm.barrier()
    return out_zip


if __name__ == "__main__":
    main()
