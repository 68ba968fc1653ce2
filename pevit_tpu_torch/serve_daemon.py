"""HTTP serving front end (counterpart of ``tools/serve_daemon.py``'s
``make_server``).

  POST /infer    body = .npy uint8 array (N, H, W, 3); response = .npy
                 float32 logits (N, K)
  GET  /healthz  {"status": "ok", "image_size": S}
  GET  /stats    pipeline and batcher counters, throughput, and latency
                 percentiles {count, mean_ms, p50_ms, p95_ms, p99_ms}

Concurrent requests are coalesced by :class:`MicroBatcher` in front of an
:class:`InferencePipeline`.  A command-line ``main`` (config and checkpoint
loading) comes with the config port.
"""

from __future__ import annotations

import io
import json
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
