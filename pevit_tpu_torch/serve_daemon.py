"""HTTP serving daemon: an exported classifier behind a socket
(counterpart of ``tools/serve_daemon.py``).

  POST /infer    body = .npy uint8 array (N, H, W, 3); response = .npy
                 float32 logits (N, K)
  GET  /healthz  {"status": "ok", "image_size": S}
  GET  /stats    pipeline and batcher counters, throughput, and latency
                 percentiles {count, mean_ms, p50_ms, p95_ms, p99_ms}

Concurrent requests are coalesced by :class:`MicroBatcher` in front of an
:class:`InferencePipeline`.  ``main`` is the command line:

    # serve an exported artifact
    python -m pevit_tpu_torch.serve_daemon --artifact cifar10.pt2 --port 8000

    # or deploy straight from a trained-state directory (program-only
    # export at start-up)
    python -m pevit_tpu_torch.serve_daemon --model resources/model/vitb32_CLIP.yaml \
        --ds resources/datasets/cifar10.yaml --weights-from /ckpts/cifar10 --port 8000

It takes the reference's flags, and ``--device`` (``cuda`` by default;
``cpu`` serves on the CPU).  SIGINT or SIGTERM stops it cleanly.
"""

from __future__ import annotations

import argparse
import io
import json
import signal
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .serve import InferencePipeline, MicroBatcher

MAX_BODY = 1 << 30  # 1 GiB request cap


def make_server(call_fn, image_size: int, *, device=None, host: str = "127.0.0.1",
                port: int = 0, max_batch: int = 256, min_bucket: int = 8, depth: int = 2,
                window_ms: float = 2.0, pad_policy: str = "bucket") -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server around ``call_fn``; the
    server's ``batcher`` must be closed by the caller after shutdown."""
    pipe = InferencePipeline(call_fn, device=device, max_batch=max_batch,
                             min_bucket=min_bucket, depth=depth, pad_policy=pad_policy)
    batcher = MicroBatcher(pipe, window_ms=window_ms)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "image_size": image_size})
            elif self.path == "/stats":
                self._json(200, {**pipe.stats, **batcher.stats,
                                 "throughput": pipe.throughput,
                                 "latency": batcher.latency_stats()})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/infer":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if not 0 < n <= MAX_BODY:
                    raise ValueError(f"bad Content-Length {n}")
                imgs = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                if imgs.dtype != np.uint8 or imgs.ndim != 4 or imgs.shape[0] == 0:
                    raise ValueError(
                        f"want uint8 (N,H,W,3) with N>0, got {imgs.dtype} {imgs.shape}")
                if imgs.shape[1:3] != (image_size, image_size):
                    raise ValueError(
                        f"model takes {image_size}x{image_size} frames, got {imgs.shape}")
            except Exception as e:  # malformed request: client error, stay up
                self._json(400, {"error": str(e)})
                return
            try:
                logits = batcher.infer(imgs)
                buf = io.BytesIO()
                np.save(buf, logits)
                self._reply(200, buf.getvalue(), "application/octet-stream")
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet access log
            pass

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.pipeline = pipe
    srv.batcher = batcher
    return srv


def config_from(ds: str, model: str, opts) -> "object":
    """The default config merged with the dataset YAML, then the model YAML,
    then the ``KEY VALUE`` overrides, as the commands merge them."""
    from .config import get_default_config, update_config

    config = get_default_config()
    for cfg_file in (ds, model):
        if cfg_file:
            update_config(config, argparse.Namespace(cfg=cfg_file, opts=opts))
    return config


def _raise_interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--artifact", default="", help=".pt2 artifact to serve")
    ap.add_argument("--model", default="", help="model YAML (checkpoint-deploy mode, "
                    "or to rebuild a program-only artifact's weight bundle)")
    ap.add_argument("--ds", default="", help="dataset YAML (sets NUM_CLASSES)")
    ap.add_argument("--method", default="kadaptation")
    ap.add_argument("--weights-from", default="", help="directory with the trained state "
                    "(step_N.npz)")
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--min-bucket", type=int, default=8)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--pad-policy", choices=["bucket", "exact"], default="bucket",
                    help="'exact' never pads ragged tails: training-equal numerics "
                         "for composition-sensitive PEFT towers, one shape per "
                         "distinct size (offline batch scoring, not public traffic)")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="cross-request micro-batching window (0 disables waiting)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = ap.parse_args(argv)

    from .serving_loader import load_serving_callable

    config = config_from(args.ds, args.model, args.opts) if (args.model or args.ds) else None
    call, image_size = load_serving_callable(
        artifact=args.artifact, config=config, method=args.method,
        weights_from=args.weights_from, quantize=args.quantize, seed=args.seed,
        device=args.device)
    srv = make_server(call, image_size, device=args.device, host=args.host, port=args.port,
                      max_batch=args.max_batch, min_bucket=args.min_bucket, depth=args.depth,
                      window_ms=args.window_ms, pad_policy=args.pad_policy)
    signal.signal(signal.SIGTERM, _raise_interrupt)
    print(f"serving on http://{args.host}:{srv.server_address[1]} "
          f"(image_size={image_size}, max_batch={args.max_batch}, "
          f"depth={args.depth})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        srv.batcher.close()


if __name__ == "__main__":
    main()
