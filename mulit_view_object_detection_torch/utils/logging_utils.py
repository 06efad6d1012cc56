"""Observability: metrics logging and profiling.

A copy of `mulit_view_object_detection_tpu/utils/logging_utils.py` (the
port imports nothing of the JAX package) with `profile_trace` on
torch.profiler instead of jax.profiler.

The reference's observability is TensorBoard scalars and debug prints
(SURVEY.md section 5; TensorBoard callback at reference model.py:
2346-2348). Here: a JSONL metrics writer (tooling-agnostic), a
dependency-free TensorBoard event-file writer (so `tensorboard --logdir`
works on these runs as on the reference's; its bytes equal the JAX
package's for the same wall time), a timer, and torch.profiler trace
capture into a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import struct
import time


class MetricsLogger:
    """Append-only JSONL metrics log: one {step, time, **metrics} per line."""

    def __init__(self, log_dir, filename="metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a", buffering=1)

    def log(self, step, **metrics):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()


# --------------------------------------------------------------------- #
# TensorBoard event files, without a TensorFlow/tensorboardX dependency.
#
# A tfevents file is a sequence of length-framed records:
#   uint64le payload_len | uint32le masked_crc32c(len bytes)
#   | payload | uint32le masked_crc32c(payload)
# where payload is a serialized tensorflow.Event protobuf. Scalars ride
# Event.summary.value[].simple_value. Only three proto features are
# needed (varints, fixed 32/64-bit scalars, length-delimited submessages),
# so the encoding is done by hand below.
# --------------------------------------------------------------------- #

_CRC32C_TABLE = []


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum TF record framing uses."""
    if not _CRC32C_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC32C_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_len(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event_proto(wall_time: float, step: int | None = None,
                 file_version: str | None = None,
                 scalars: dict | None = None) -> bytes:
    # Event: 1=wall_time double, 2=step int64, 3=file_version, 5=summary
    msg = bytearray(b"\x09" + struct.pack("<d", wall_time))
    if step is not None:
        msg += b"\x10" + _varint(int(step) & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        msg += _field_len(3, file_version.encode())
    if scalars:
        summary = bytearray()
        for tag, value in scalars.items():
            # Summary.Value: 1=tag, 2=simple_value float
            val = (_field_len(1, tag.encode())
                   + b"\x15" + struct.pack("<f", float(value)))
            summary += _field_len(1, val)
        msg += _field_len(5, bytes(summary))
    return bytes(msg)


def _framed(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TBEventWriter:
    """Write TensorBoard scalar event files (`events.out.tfevents.*`).

    Drop-in for the reference's per-epoch TensorBoard scalars
    (model.py:2346-2348) with zero heavyweight dependencies; the files
    load in stock TensorBoard / tensorboard.backend.event_processing.
    """

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir,
            f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}")
        self._f = open(self.path, "ab")
        self._write(_event_proto(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        self._f.write(_framed(payload))
        self._f.flush()

    def add_scalars(self, step, scalars):
        """Log a {tag: float} dict at `step` as one Event."""
        self._write(_event_proto(time.time(), step=step, scalars=scalars))

    def close(self):
        self._f.close()


def read_tb_events(path):
    """Parse a tfevents file -> list of (step, {tag: value}) scalar events.

    Validates record framing CRCs; used by tests and handy for quick
    inspection without TensorBoard.
    """
    events = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        header = data[off:off + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[off + 8:off + 12])
        if hcrc != _masked_crc(header):
            raise ValueError(f"bad header crc at offset {off}")
        payload = data[off + 12:off + 12 + length]
        (pcrc,) = struct.unpack(
            "<I", data[off + 12 + length:off + 16 + length])
        if pcrc != _masked_crc(payload):
            raise ValueError(f"bad payload crc at offset {off}")
        off += 16 + length
        events.append(_parse_event(payload))
    return [(step, scalars) for step, scalars in events if scalars]


def _parse_event(payload: bytes):
    """Minimal Event proto decoder (step + Summary simple_values)."""
    step, scalars = 0, {}
    off = 0
    while off < len(payload):
        key, off = _read_varint(payload, off)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(payload, off)
            if num == 2:
                step = val
        elif wire == 1:
            off += 8
        elif wire == 5:
            off += 4
        elif wire == 2:
            length, off = _read_varint(payload, off)
            chunk = payload[off:off + length]
            off += length
            if num == 5:  # summary
                scalars.update(_parse_summary(chunk))
        else:  # pragma: no cover - unused wire types
            raise ValueError(f"unsupported wire type {wire}")
    return step, scalars


def _parse_summary(payload: bytes):
    scalars = {}
    off = 0
    while off < len(payload):
        key, off = _read_varint(payload, off)
        length, off = _read_varint(payload, off)
        value = payload[off:off + length]
        off += length
        if key >> 3 != 1:
            continue
        tag, simple, voff = None, None, 0
        while voff < len(value):
            vkey, voff = _read_varint(value, voff)
            vnum, vwire = vkey >> 3, vkey & 7
            if vwire == 2:
                vlen, voff = _read_varint(value, voff)
                if vnum == 1:
                    tag = value[voff:voff + vlen].decode()
                voff += vlen
            elif vwire == 5:
                if vnum == 2:
                    (simple,) = struct.unpack("<f", value[voff:voff + 4])
                voff += 4
            elif vwire == 1:
                voff += 8
            else:
                _, voff = _read_varint(value, voff)
        if tag is not None and simple is not None:
            scalars[tag] = simple
    return scalars


def _read_varint(data: bytes, off: int):
    result = shift = 0
    while True:
        b = data[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


@contextlib.contextmanager
def profile_trace(log_dir):
    """Profile the block with torch.profiler (the CPU, and the card when
    one is available) and write a Chrome trace,
    `<log_dir>/trace.<time>.json` (open it in Perfetto or
    chrome://tracing). Yields the profiler."""
    import torch

    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace.{time.time_ns()}.json"))


@contextlib.contextmanager
def timed(name, sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"{name}: {time.perf_counter() - t0:.3f}s")
