"""Serving throughput benchmark: an exported classifier through the
serving paths.

Counterpart of ``tools/serve_bench.py``.  Measures sustained images/s of a
``.pt2`` artifact (or a freshly exported program-only one) along these
paths and prints one JSON line per arm:

* ``naive``: transfer -> compute -> fetch, strictly serial per batch;
* ``pipeN``: :class:`pevit_tpu_torch.serve.InferencePipeline` with N
  batches in flight (the host pads and ships batch i+1 while the card
  computes batch i);
* ``daemonN`` (``--clients N``): the HTTP daemon
  (``pevit_tpu_torch.serve_daemon``) under N concurrent clients posting
  ``--client-batch``-image requests over localhost sockets;
* ``mix-<policy>`` (``--request-sizes``): a ragged request-size mix through
  the pipeline under each of ``--pad-policies``.

Every arm's logits are gated against the first arm's.

    # fresh export, ViT-B/32, bf16, batch 256, 8192 synthetic images
    python -m pevit_tpu_torch.tools.serve_bench --model resources/model/vitb32_CLIP.yaml \\
        --batch 256 --images 8192 MODEL.PRETRAINED random

    # replay a program-only artifact with its trained state
    python -m pevit_tpu_torch.tools.serve_bench --artifact clf.pt2 --weights-from ckpt/ \\
        --model resources/model/vitb32_CLIP.yaml --ds resources/datasets/cifar10.yaml
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
import urllib.request

import numpy as np
import torch


def _gate(name: str, rep: int, out: np.ndarray, ref: np.ndarray) -> None:
    """An arm's logits against the first arm's.  The daemon's coalesced
    groups run other batch shapes, whose bf16 rounding differs, so the gate
    is relative plus argmax agreement; the mix repartitions the stream and
    bucket padding moves a composition-sensitive tower's logits, so there
    it catches only rows routed to the wrong request."""
    m = min(len(out), len(ref))  # the daemon arm trims to clients * per_client
    scale = float(np.abs(ref[:m]).max()) or 1.0
    maxd = float(np.abs(out[:m] - ref[:m]).max())
    agree = float((out[:m].argmax(1) == ref[:m].argmax(1)).mean())
    if name.startswith("mix-"):
        if agree < 0.90 or maxd > 0.5 * scale:
            raise SystemExit(f"{name} rep{rep}: row routing broken vs the first arm "
                             f"(max|d|={maxd:.4f} at scale {scale:.2f}, "
                             f"argmax agreement {agree:.4f})")
        print(f"#   {name}: argmax agreement {agree:.4f}, max|d| {maxd:.4f} vs the batch arm",
              flush=True)
    elif maxd > 0.02 * scale or agree < 0.995:
        raise SystemExit(f"{name} rep{rep}: logits mismatch vs the first arm "
                         f"(max|d|={maxd:.4f} at scale {scale:.2f}, "
                         f"argmax agreement {agree:.4f})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--artifact", default="", help="replay this .pt2 artifact "
                    "(default: fresh export from --model/--ds)")
    ap.add_argument("--model", default="", help="model YAML (fresh-export mode)")
    ap.add_argument("--ds", default="", help="dataset YAML (sets NUM_CLASSES)")
    ap.add_argument("--method", default="kadaptation")
    ap.add_argument("--weights-from", default="", help="directory with the trained state "
                    "(program-only artifacts / fresh export)")
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--images", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--depths", default="2,3", help="pipeline depths to measure")
    ap.add_argument("--clients", type=int, default=0,
                    help="add a daemon arm with this many concurrent HTTP clients")
    ap.add_argument("--client-batch", type=int, default=16,
                    help="images per HTTP request in the daemon arm")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="daemon micro-batching window")
    ap.add_argument("--request-sizes", default="",
                    help="comma list of ragged request sizes: adds a mixed-size "
                         "request-stream arm per --pad-policies entry")
    ap.add_argument("--pad-policies", default="bucket,exact",
                    help="policies measured by the --request-sizes arm")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = ap.parse_args(argv)

    from .. import serve_daemon
    from ..serve import InferencePipeline
    from ..serving_loader import load_serving_callable
    from ..utils.device import resolve_device

    if not args.artifact and not args.model:
        raise SystemExit("need --model (fresh export) or --artifact (replay)")
    dev = resolve_device(args.device)
    config = None
    if args.model or args.ds:
        config = serve_daemon.config_from(args.ds, args.model, args.opts)
        if int(config.DATASET.NUM_CLASSES) <= 0:
            # any head size exercises the same program: 100 classes when no
            # dataset YAML pins one
            config.defrost()
            config.DATASET.NUM_CLASSES = 100
            config.freeze()
            print("# no --ds: benching with a 100-class head", flush=True)
    call, image_size = load_serving_callable(
        artifact=args.artifact, config=config, method=args.method,
        weights_from=args.weights_from, quantize=args.quantize, seed=args.seed, device=dev)

    rng = np.random.default_rng(args.seed)
    n = (args.images // args.batch) * args.batch or args.batch
    stream = rng.integers(0, 256, (n, image_size, image_size, 3), np.uint8)
    depths = [int(x) for x in args.depths.split(",") if x]

    def fetch(logits) -> np.ndarray:
        return logits.float().cpu().numpy()

    t0 = time.time()
    num_classes = fetch(call(torch.from_numpy(stream[: args.batch]).to(dev))).shape[-1]
    print(f"# warmup {time.time() - t0:.1f}s", flush=True)

    def run_naive():
        out = []
        for off in range(0, n, args.batch):
            out.append(fetch(call(torch.from_numpy(stream[off:off + args.batch]).to(dev))))
        return np.concatenate(out)

    def run_pipe(depth):
        pipe = InferencePipeline(call, device=dev, max_batch=args.batch,
                                 min_bucket=args.batch, depth=depth)
        return pipe(stream)

    def run_daemon():
        """The HTTP daemon under --clients concurrent posters."""
        srv = serve_daemon.make_server(call, image_size, device=dev, port=0,
                                       max_batch=args.batch, min_bucket=8,
                                       depth=max(depths, default=2), window_ms=args.window_ms)
        st = threading.Thread(target=srv.serve_forever, daemon=True)
        st.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}/infer"
        per_client = n // args.clients
        out = np.empty((n, num_classes), np.float32)
        errors = []

        def client(cid):
            try:
                for off in range(cid * per_client, (cid + 1) * per_client, args.client_batch):
                    chunk = stream[off: min(off + args.client_batch, (cid + 1) * per_client)]
                    buf = io.BytesIO()
                    np.save(buf, chunk)
                    req = urllib.request.Request(url, data=buf.getvalue())
                    with urllib.request.urlopen(req, timeout=600) as r:
                        out[off: off + chunk.shape[0]] = np.load(io.BytesIO(r.read()))
            except Exception as e:  # surfaced in the main thread below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(args.clients)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            srv.shutdown()
            srv.server_close()
            srv.batcher.close()
            st.join(timeout=30)
        if errors:
            raise errors[0]
        stats = srv.batcher.stats
        print(f"#   daemon: {stats['requests']} requests coalesced into {stats['groups']} "
              f"device groups", flush=True)
        print(f"#   daemon latency: {srv.batcher.latency_stats()}", flush=True)
        return out[: per_client * args.clients]

    mix_sizes = [int(x) for x in args.request_sizes.split(",") if x]

    def run_mix(policy):
        """The ragged request-size mix through the pipeline under one pad
        policy: 'bucket' pads each ragged chunk to a power of two, 'exact'
        runs every size as it is (training-equal numerics)."""
        pipe = InferencePipeline(call, device=dev, max_batch=args.batch, min_bucket=8,
                                 depth=max(depths, default=2), pad_policy=policy)
        reqs, off, i = [], 0, 0
        while off < n:
            s = min(mix_sizes[i % len(mix_sizes)], n - off)
            reqs.append(stream[off:off + s])
            off += s
            i += 1
        return np.concatenate(pipe.run(reqs))

    arms = [("naive", run_naive)] + [(f"pipe{d}", (lambda d=d: run_pipe(d))) for d in depths]
    if args.clients:
        arms.append((f"daemon{args.clients}", run_daemon))
    if mix_sizes:
        arms += [(f"mix-{pol}", lambda pol=pol: run_mix(pol))
                 for pol in (p.strip() for p in args.pad_policies.split(",")) if pol]
    results = {name: [] for name, _ in arms}
    last_out = {}
    ref = None
    for rep in range(args.reps):  # interleaved reps: drift hits every arm
        for name, fn in arms:
            t0 = time.time()
            out = fn()
            dt = time.time() - t0
            results[name].append(len(out) / dt)
            last_out[name] = out
            if ref is None:
                ref = out
            else:
                _gate(name, rep, out, ref)
            print(f"# {name} rep{rep}: {len(out) / dt:.0f} img/s ({dt:.1f}s)", flush=True)

    if "mix-bucket" in last_out and "mix-exact" in last_out:
        d = float(np.abs(last_out["mix-bucket"] - last_out["mix-exact"]).max())
        s = float(np.abs(last_out["mix-exact"]).max()) or 1.0
        print(f"# pad-policy numerics: max|bucket - exact| = {d:.6f} (logit scale {s:.2f})",
              flush=True)
    for name, vals in results.items():
        rec = {"arm": name, "img_per_s_best": max(vals), "img_per_s_all": vals,
               "batch": args.batch, "images": n, "device": str(dev)}
        if name.startswith("mix-"):
            rec["request_sizes"] = mix_sizes
        print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    main()
