"""Minimal production-style HTTP serving endpoint (stdlib only).

A copy of `mulit_view_object_detection_tpu/serve/http_server.py`, not an
import of it (the port imports nothing of the JAX package); the wire
protocol is byte for byte the same, so a client of either package talks
to a server of the other.

Wraps an inference engine + `MicroBatcher` behind a threaded HTTP server:
concurrent POSTs from independent clients land in the same fixed-size
device batch. No web framework — `http.server.ThreadingHTTPServer` is
enough because all device work is serialized by the batcher's single
dispatcher thread; handler threads only decode and encode npz.

Protocol (binary, numpy `.npz` both ways — no JSON re-encoding of
image tensors):

  POST /detect   body: npz{views [V,H,W,3] uint8, Rcam [1,V,3,4] f32,
                           Kmat [1,3,3] f32, depths? }
                 resp: npz{rois, class_ids, scores, masks}
  GET  /stats    batcher counters as JSON
  GET  /healthz  200 "ok"

Client helper: `detect_remote(url, views, Rcam, Kmat)`.
"""

from __future__ import annotations

import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .batcher import MicroBatcher


def _encode_npz(arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _decode_npz(data):
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


class ServingHandler(BaseHTTPRequestHandler):
    # set by make_server:
    batcher: MicroBatcher = None
    request_timeout_s: float = 2400.0

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code, body, ctype="application/octet-stream"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, b"ok", "text/plain")
        elif self.path == "/stats":
            body = json.dumps(self.batcher.stats()).encode()
            self._send(200, body, "application/json")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        if self.path != "/detect":
            self._send(404, b"not found", "text/plain")
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = _decode_npz(self.rfile.read(length))
            views = payload["views"]
            future = self.batcher.submit(
                views,
                Rcam=payload.get("Rcam"),
                Kmat=payload.get("Kmat"),
                depths=payload.get("depths"))
            result = future.result(timeout=self.request_timeout_s)
            body = _encode_npz({
                "rois": result["rois"],
                "class_ids": result["class_ids"],
                "scores": result["scores"],
                "masks": result["masks"],
            })
            self._send(200, body)
        except Exception as e:  # noqa: BLE001 - report to the client
            self._send(500, str(e).encode(), "text/plain")


def make_server(engine, port=0, batch_size=4, max_delay_ms=10.0,
                host="127.0.0.1"):
    """Build (server, batcher). `port=0` picks a free port
    (`server.server_address[1]`). Call `server.serve_forever()` (e.g. in
    a thread) and `server.shutdown()` + `batcher.close()` to stop."""
    batcher = MicroBatcher(engine, batch_size=batch_size,
                           max_delay_ms=max_delay_ms)
    handler = type("BoundServingHandler", (ServingHandler,),
                   {"batcher": batcher})
    server = ThreadingHTTPServer((host, port), handler)
    return server, batcher


def serve_forever(engine, port, batch_size=4, max_delay_ms=10.0):
    """Blocking entry point used by the CLI."""
    server, batcher = make_server(engine, port=port, batch_size=batch_size,
                                  max_delay_ms=max_delay_ms)
    try:
        server.serve_forever()
    finally:
        batcher.close()


def detect_remote(url, views, Rcam=None, Kmat=None, depths=None,
                  timeout=2400.0):
    """Client helper: POST one scene to a serving endpoint; returns the
    detect()-style result dict."""
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen

    arrays = {"views": np.asarray(views)}
    if Rcam is not None:
        arrays["Rcam"] = np.asarray(Rcam, np.float32)
    if Kmat is not None:
        arrays["Kmat"] = np.asarray(Kmat, np.float32)
    if depths is not None:
        arrays["depths"] = np.asarray(depths, np.float32)
    req = Request(url.rstrip("/") + "/detect", data=_encode_npz(arrays),
                  headers={"Content-Type": "application/octet-stream"})
    try:
        with urlopen(req, timeout=timeout) as resp:
            return _decode_npz(resp.read())
    except HTTPError as e:
        # surface the server's diagnostic body, not just the status code
        detail = e.read().decode("utf-8", "replace")
        raise RuntimeError(f"serving error {e.code}: {detail}") from e
