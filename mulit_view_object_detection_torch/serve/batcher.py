"""Serving-time request micro-batching.

A copy of `mulit_view_object_detection_tpu/serve/batcher.py`, not an
import of it: the port imports nothing of the JAX package, not even a
module that itself imports no jax, so that it runs where jax is not
installed. Same semantics, so either package's engine can sit behind
either batcher.

The reference has no serving layer at all (inference is the
`model.detect()` python loop, model.py:2510-2545). `MicroBatcher` turns
independent single-scene requests into fixed-size batches:

  * requests (`submit()`) enqueue and immediately return a
    `concurrent.futures.Future`;
  * ONE dispatcher thread collects up to `batch_size` requests, waiting
    at most `max_delay_ms` after the first arrival (latency bound), pads
    the tail with a copy of the first request, and runs the engine once;
    padded results are dropped;
  * a FIXED batch size keeps one set of shapes on the card, so the
    engine's anchor cache and cuDNN's choice of algorithm for each
    convolution are made once and reused, and the per-launch host
    overhead of the eager forward is spread over the batch;
  * requests batch only with an identical signature (which optional
    fields they carry, and their shapes);
  * the single dispatcher thread also owns the card: every detect call
    runs on it, one at a time.

Works with any engine exposing the `compat.MaskRCNN.detect` signature.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np


class _Request:
    __slots__ = ("views", "Rcam", "Kmat", "depths", "future", "t_submit",
                 "signature")

    def __init__(self, views, Rcam, Kmat, depths):
        self.views = views
        self.Rcam = Rcam
        self.Kmat = Kmat
        self.depths = depths
        self.future = Future()
        self.t_submit = time.monotonic()
        # requests only batch with identical field presence and shapes
        self.signature = (
            views.shape,
            None if Rcam is None else np.asarray(Rcam).shape,
            None if Kmat is None else np.asarray(Kmat).shape,
            None if depths is None else np.asarray(depths).shape,
        )


class MicroBatcher:
    """Batch independent detect() requests onto one engine.

    Parameters
    ----------
    engine : object with ``detect(images, Rcam=, Kmat=, depths=) -> [dict]``
        (e.g. ``compat.MaskRCNN`` in inference mode). The engine's config
        BATCH_SIZE should equal ``batch_size``.
    batch_size : int
        Fixed dispatch batch; short batches are padded (padding results
        are dropped, never returned).
    max_delay_ms : float
        Max time the dispatcher waits for the batch to fill after the
        first request arrives.
    """

    def __init__(self, engine, batch_size=4, max_delay_ms=5.0):
        self.engine = engine
        self.batch_size = int(batch_size)
        self.max_delay = float(max_delay_ms) / 1000.0
        self._queue = queue.Queue()
        self._pending = []   # dispatcher-thread only: signature mismatches
        self._closed = threading.Event()
        # serializes the closed-check+enqueue in submit() against close()
        # setting the flag: without it a submit could pass the check, lose
        # the CPU while close() drains the queue, then enqueue into a
        # dead batcher — its future stranded forever
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "completed": 0, "batches": 0,
                       "padded_slots": 0, "latency_ms_sum": 0.0}
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="microbatcher", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- API
    def submit(self, views, Rcam=None, Kmat=None, depths=None):
        """Enqueue one scene (views [V,H,W,3], Rcam [1,V,3,4],
        Kmat [1,3,3]); returns a Future resolving to the detect() result
        dict for this scene."""
        req = _Request(np.asarray(views), Rcam, Kmat, depths)
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("MicroBatcher is closed")
            self._queue.put(req)
        with self._stats_lock:
            self._stats["requests"] += 1
        return req.future

    def stats(self):
        """Counters: requests, completed, batches, padded_slots,
        mean_latency_ms (over COMPLETED requests)."""
        with self._stats_lock:
            s = dict(self._stats)
        s["mean_latency_ms"] = (s.pop("latency_ms_sum") / s["completed"]
                                if s["completed"] else 0.0)
        return s

    def close(self, timeout=30.0):
        """Drain the queue, stop the dispatcher, fail late submits. Any
        request that raced past the closed check after the dispatcher
        exited is failed, not stranded."""
        with self._submit_lock:     # no submit between its check and put
            self._closed.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():   # still dispatching; don't race it
            return
        stranded = list(self._pending)
        self._pending.clear()
        while True:
            try:
                stranded.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for req in stranded:
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("MicroBatcher closed before dispatch"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -------------------------------------------------------- internals
    def _collect(self):
        """Block for the first request, then fill up to batch_size within
        max_delay. Only requests with an IDENTICAL field signature
        (optional-field presence + shapes) share a batch — a mismatched
        request waits for its own batch instead of poisoning this one.
        Returns [] when closing with nothing left to serve."""
        while True:
            if self._pending:
                first = self._pending.pop(0)
                break
            try:
                first = self._queue.get(timeout=0.05)
                break
            except queue.Empty:
                if self._closed.is_set():
                    return []
        batch = [first]
        deadline = time.monotonic() + self.max_delay
        while len(batch) < self.batch_size:
            matched = next((i for i, r in enumerate(self._pending)
                            if r.signature == first.signature), None)
            if matched is not None:
                batch.append(self._pending.pop(matched))
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req.signature == first.signature:
                batch.append(req)
            else:
                self._pending.append(req)
        return batch

    def _dispatch_loop(self):
        while True:
            batch = self._collect()
            if not batch:
                if (self._closed.is_set() and self._queue.empty()
                        and not self._pending):
                    return
                continue
            n = len(batch)
            pad = self.batch_size - n
            reqs = batch + [batch[0]] * pad
            try:
                images = [r.views for r in reqs]
                kwargs = {}
                if reqs[0].Rcam is not None:
                    kwargs["Rcam"] = np.concatenate(
                        [np.asarray(r.Rcam, np.float32) for r in reqs])
                if reqs[0].Kmat is not None:
                    kwargs["Kmat"] = np.concatenate(
                        [np.asarray(r.Kmat, np.float32) for r in reqs])
                if reqs[0].depths is not None:
                    kwargs["depths"] = np.concatenate(
                        [np.asarray(r.depths, np.float32) for r in reqs])
                results = self.engine.detect(images, **kwargs)
                if len(results) < n:
                    raise RuntimeError(
                        f"engine returned {len(results)} results for a "
                        f"batch of {len(reqs)}")
                now = time.monotonic()
                with self._stats_lock:
                    self._stats["batches"] += 1
                    self._stats["completed"] += n
                    self._stats["padded_slots"] += pad
                    self._stats["latency_ms_sum"] += sum(
                        (now - r.t_submit) * 1000.0 for r in batch)
                for r, res in zip(batch, results[:n]):
                    r.future.set_result(res)
            except Exception as e:  # noqa: BLE001 - fail futures, keep serving
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
