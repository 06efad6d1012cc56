"""Profile an inference and print the top device ops by total time.

    python -m mulit_view_object_detection_torch.cli.trace_analysis \\
        [variant] [--trace trace.json] [--top 40] [--device cuda]

The port's copy of the top-level `tools/trace_analysis.py`, which reads
a jax.profiler perfetto trace. Here `capture` takes a torch.profiler
trace (CPU and CUDA activities) of 3 inferences of a
`cli/profile_variants.py` variant (default conv3d, BN-folded, seeded
weights) after one warm-up, exported as Chrome trace JSON; `--trace`
reads such a file in place of a fresh capture. `top_ops` reads the
trace as the JAX tool reads its own: the complete ("X") events of the
device tracks only — CUDA kernels, memcpys and memsets, told apart by
their category — so that host threads, which overlap the device work,
neither pollute the ranking nor count twice; when the trace has no
device event (a CPU run) it falls back to every track, and the header
line says which it used. `busy_and_span` gives the trace's own idle
share: the union of the device events' intervals against the span of
the trace's events (host and device), which brackets the captured loop.

Runs on the card unless `--device cpu` is passed; asked for cuda without
a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from collections import defaultdict

import torch

from .measure import inference_setup, infer_loop, resolve_device, synchronize
from .profile_variants import variant_config

# torch.profiler's Chrome trace categories of the device's own work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def capture(variant="conv3d", device="cuda", path=None):
    """A torch.profiler trace of 3 inferences of `variant` after one
    warm-up, written to `path` (a temporary file if None) as Chrome trace
    JSON; returns the path."""
    device = resolve_device(device)
    model, inputs = inference_setup(variant_config(variant), device)
    infer_loop(model, inputs, 1)
    synchronize(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        infer_loop(model, inputs, 3)
        synchronize(device)
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="trace_")
        os.close(fd)
    prof.export_chrome_trace(path)
    return path


def load(path):
    with open(path) as f:
        return json.load(f)


def _complete(trace):
    return [ev for ev in trace.get("traceEvents", []) if ev.get("ph") == "X"]


def busy_and_span(trace):
    """(device busy ms, span ms): the union of the device events'
    intervals, and first start to last end of every complete event; the
    device is idle 1 - busy / span of the traced time. (0, span) when
    the trace has no device event."""
    spans = [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)),
              ev.get("cat") in DEVICE_CATEGORIES) for ev in _complete(trace)]
    if not spans:
        return 0.0, 0.0
    span = max(end for _, end, _ in spans) - min(s for s, _, _ in spans)
    busy, reach = 0.0, float("-inf")
    for start, end, on_device in sorted(spans):
        if on_device and end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy / 1e3, span / 1e3


def top_ops(trace, n=40):
    """The `n` op names of most total duration: (scope, total ms,
    [(name, ms, count), ...]). `trace` is a Chrome trace dict; scope is
    "device" when it has kernel, memcpy or memset events (only those
    count), else "all" (every complete event)."""
    events = _complete(trace)
    device = [ev for ev in events if ev.get("cat") in DEVICE_CATEGORIES]
    scope = "device" if device else "all"
    durations, counts = defaultdict(float), defaultdict(int)
    for ev in device or events:
        name = ev.get("name", "?")
        durations[name] += float(ev.get("dur", 0))
        counts[name] += 1
    top = sorted(durations.items(), key=lambda kv: -kv[1])[:n]
    return (scope, sum(durations.values()) / 1e3,
            [(name, dur / 1e3, counts[name]) for name, dur in top])


def format_top(scope, total_ms, rows):
    where = ("device tracks (kernels, memcpy, memset)" if scope == "device"
             else "all tracks (no device event found)")
    lines = [f"total traced event time: {total_ms:.3f} ms "
             f"(3 steps, {where})"]
    lines += [f"{ms:10.3f} ms  x{count:<5} {name[:110]}"
              for name, ms, count in rows]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variant", nargs="?", default="conv3d")
    ap.add_argument("--trace", help="a Chrome trace JSON to read in place "
                                    "of a fresh capture")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    path = args.trace or capture(args.variant, args.device)
    try:
        trace = load(path)
        print(format_top(*top_ops(trace, args.top)), flush=True)
        busy, span = busy_and_span(trace)
        if busy:
            print(f"device busy {busy:.3f} ms of the trace's {span:.3f} ms "
                  f"(idle {1 - busy / span:.1%})", flush=True)
    finally:
        if not args.trace:
            os.remove(path)


if __name__ == "__main__":
    main()
