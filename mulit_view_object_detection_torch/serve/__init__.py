"""Serving: request micro-batching and the stdlib HTTP endpoint."""

from .batcher import MicroBatcher
from .http_server import detect_remote, make_server, serve_forever

__all__ = ["MicroBatcher", "detect_remote", "make_server",
           "serve_forever"]
