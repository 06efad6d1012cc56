"""The port's measurement tools on the CPU, against the JAX tools they
copy: `cli/profile_variants.py` (its configs and the flagship training
workload), `cli/trace_analysis.py` (the trace reader) and
`cli/bench_input.py` (the input pipeline's batches). The FLOP count of
`cli/mfu_report.py` is held to the JAX jaxpr in
tests/test_torch_tools_flops.py.

* `variant_config` equals JAX `tools/profile_variants.py`'s key for key,
  every variant at batch 1 and 4, JAX's TPU lowerings set from the
  environment at BENCH_ZFOLD=0, BENCH_PHASE_DECONV=0, BENCH_LSTM_HOIST=0
  (the port runs none of them).
* `flagship_train_config` equals `bench_train.flagship_train_config`, and
  `make_flagship_train_batch` is bit-equal to JAX's with
  device_put=False.
* chip_smoke.py's FlagshipConfig, Lstm4Config and XformerConfig derive
  from `variant_config("conv3d")`, `("lstm3d4")` and `("xformer")`, and
  its FlagshipTrainConfig from `flagship_train_config()`, each setting
  only the keys the smoke sets on purpose, so that the smoke and the
  tools measure the same networks.
* `top_ops` on a hand-made trace with host and device tracks, and its
  fallback to all tracks on a CPU torch.profiler trace of a small model;
  `busy_and_span` on a hand-made trace.
* `bench_input`'s batches are bit-equal to make_batch at the same seeds
  in thread and process mode, and a worker's error surfaces as
  PrefetchError, also when the drain meets it.
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bench_train  # noqa: E402
from mulit_view_object_detection_torch.cli import (  # noqa: E402
    bench_input, measure, profile_variants as pv, trace_analysis)
from mulit_view_object_detection_torch.data.generator import (  # noqa: E402
    BatchPrefetcher, PrefetchError, make_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_ENV = {"BENCH_ZFOLD": "0", "BENCH_PHASE_DECONV": "0",
           "BENCH_LSTM_HOIST": "0"}
# the keys chip_smoke.py's configs set apart from the tools': their names,
# DETECTION_MIN_CONFIDENCE 0.0 (random weights still give detections),
# FOLD_BN, which JAX's Base turns on and the smoke's inference phases
# leave off (phase 12 serves a BN-folded copy of its own), and in the
# training config the epoch's steps and the flagship's 500 proposals for
# its detections (bench_train's config keeps the default 1000)
SMOKE_OWN_KEYS = {"NAME", "DETECTION_MIN_CONFIDENCE", "FOLD_BN"}
SMOKE_TRAIN_KEYS = {"NAME", "DETECTION_MIN_CONFIDENCE",
                    "POST_NMS_ROIS_INFERENCE", "STEPS_PER_EPOCH",
                    "VALIDATION_STEPS"}


@pytest.fixture(scope="module")
def jax_profile_variants():
    """JAX tools/profile_variants.py, imported afresh with its TPU
    lowerings' environment variables at 0 (its Base reads them when the
    module is imported)."""
    saved = {k: os.environ.get(k) for k in TPU_ENV}
    os.environ.update(TPU_ENV)
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_profile_variants",
            os.path.join(ROOT, "tools", "profile_variants.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name", pv.VARIANTS)
def test_variant_config_equals_jax(name, batch, jax_profile_variants,
                                   monkeypatch):
    for k, v in TPU_ENV.items():
        monkeypatch.setenv(k, v)
    want = jax_profile_variants.variant_config(name, batch).to_dict()
    got = pv.variant_config(name, batch).to_dict()
    assert sorted(got) == sorted(want)
    np.testing.assert_equal(got, want)
    assert got["BATCH_SIZE"] == batch
    assert not any(got[k] for k in ("ZFOLD_FUSION", "PHASE_DECONV",
                                    "LSTM_HOIST_INPUT"))


@pytest.mark.parametrize("batch,remat", [(1, False), (2, True)])
def test_flagship_train_config_equals_bench_train(batch, remat):
    want = bench_train.flagship_train_config(batch, remat, "mfu").to_dict()
    got = measure.flagship_train_config(batch, remat, "mfu").to_dict()
    assert sorted(got) == sorted(want)
    np.testing.assert_equal(got, want)


def test_flagship_train_batch_bit_equal_to_bench_train():
    cfg = measure.flagship_train_config()
    want = bench_train.make_flagship_train_batch(cfg, device_put=False)
    got = measure.make_flagship_train_batch(cfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# each of chip_smoke.py's configs: the class it derives from, the keys it sets
SMOKE_CONFIGS = {
    "FlagshipConfig": ('type(variant_config("conv3d"))', SMOKE_OWN_KEYS),
    "Lstm4Config": ('type(variant_config("lstm3d4"))', SMOKE_OWN_KEYS),
    "XformerConfig": ('type(variant_config("xformer"))', SMOKE_OWN_KEYS),
    "FlagshipTrainConfig": ("type(flagship_train_config())",
                            SMOKE_TRAIN_KEYS)}


@pytest.mark.parametrize("smoke", list(SMOKE_CONFIGS))
def test_chip_smoke_configs_are_the_tool_variants(smoke):
    """Read from chip_smoke.py's source (importing it needs a card)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        classes = {node.name: node for node in ast.parse(f.read()).body
                   if isinstance(node, ast.ClassDef)}
    node, (base, keys) = classes[smoke], SMOKE_CONFIGS[smoke]
    assert [ast.unparse(b) for b in node.bases] == [
        ast.unparse(ast.parse(base, mode="eval"))]
    assert {t.id for st in node.body if isinstance(st, ast.Assign)
            for t in st.targets} == keys


# ---------------------------------------------------------------------------
# trace_analysis
# ---------------------------------------------------------------------------

def _event(name, cat, dur, pid=1, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "dur": dur, "pid": pid,
            "tid": tid, "ts": 0}


def test_top_ops_reads_the_device_tracks():
    """Host events (cpu_op, cuda_runtime, python_function) are left out
    when device events exist; kernels, memcpys and memsets are summed by
    name, in descending total."""
    trace = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
        _event("aten::conv2d", "cpu_op", 5000.0, pid=0),
        _event("cudaLaunchKernel", "cuda_runtime", 900.0, pid=0),
        _event("forward", "python_function", 8000.0, pid=0),
        _event("fwd_kernel<bf16>", "kernel", 12.5),
        _event("fwd_kernel<bf16>", "kernel", 7.5),
        _event("cutlass_gemm", "kernel", 30.0),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 4.0),
        _event("Memset (Device)", "gpu_memset", 1.0),
        {"ph": "i", "name": "marker", "cat": "kernel", "pid": 1},
    ]}
    scope, total, rows = trace_analysis.top_ops(trace, n=3)
    assert scope == "device"
    assert total == pytest.approx(0.055)
    assert rows == [("cutlass_gemm", pytest.approx(0.030), 1),
                    ("fwd_kernel<bf16>", pytest.approx(0.020), 2),
                    ("Memcpy HtoD (Pageable -> Device)",
                     pytest.approx(0.004), 1)]
    assert "device tracks" in trace_analysis.format_top(scope, total, rows)


def test_busy_and_span_of_a_hand_made_trace():
    """Device events at [10, 30), [20, 40) and [50, 55) us: busy 35 us of
    the span [0, 100) that the host events cover; a trace without device
    events is busy 0."""
    def at(ev, ts):
        return dict(ev, ts=ts)
    host = [at(_event("forward", "python_function", 100.0, pid=0), 0),
            at(_event("cudaLaunchKernel", "cuda_runtime", 5.0, pid=0), 8)]
    device = [at(_event("a", "kernel", 20.0), 10),
              at(_event("b", "kernel", 20.0), 20),
              at(_event("Memset (Device)", "gpu_memset", 5.0), 50)]
    busy, span = trace_analysis.busy_and_span(
        {"traceEvents": host + device})
    assert (busy, span) == (pytest.approx(0.035), pytest.approx(0.1))
    assert trace_analysis.busy_and_span({"traceEvents": host}) == (
        0.0, pytest.approx(0.1))


class _TinyTrace(pv.Base):
    NUM_VIEWS = 2
    GRID_REAS = "conv3d"
    IMAGE_MIN_DIM = 64
    IMAGE_MAX_DIM = 64
    RESNET50_STAGE4_BLOCKS = 1
    TOP_DOWN_PYRAMID_SIZE = 16
    nvox = 8
    nvox_z = 8
    samples = 4
    PRE_NMS_LIMIT = 200
    POST_NMS_ROIS_INFERENCE = 50
    DETECTION_MAX_INSTANCES = 10
    COMPUTE_DTYPE = "float32"


def test_top_ops_falls_back_to_all_tracks_on_a_cpu_trace(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(trace_analysis, "variant_config",
                        lambda name: _TinyTrace())
    path = trace_analysis.capture(device="cpu",
                                  path=str(tmp_path / "t.json"))
    scope, total, rows = trace_analysis.top_ops(trace_analysis.load(path))
    assert scope == "all" and total > 0 and rows
    names = [r[0] for r in rows]
    assert any("conv" in n for n in names), names[:10]
    assert "all tracks" in trace_analysis.format_top(scope, total, rows)


# ---------------------------------------------------------------------------
# bench_input
# ---------------------------------------------------------------------------

SIZE, VIEWS = 64, 2


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_bench_input_thread_batches_are_make_batch():
    """One thread: the k-th batch is make_batch at seed k + 1
    (BatchPrefetcher counts its seeds from 1)."""
    cfg, fn = bench_input.make_fn(SIZE, VIEWS)
    pf = bench_input.prefetcher("thread", fn, 1)
    try:
        got = [next(pf) for _ in range(3)]
    finally:
        pf.close()
    for k, batch in enumerate(got):
        _assert_batches_equal(batch, make_batch(fn.ds, cfg, rnd_state=k + 1,
                                                augmentation=fn.aug))


def test_bench_input_process_batches_are_make_batch():
    """Two spawned workers: the k-th batch is make_batch at seed k."""
    cfg, fn = bench_input.make_fn(SIZE, VIEWS)
    pf = bench_input.prefetcher("process", fn, 2)
    try:
        got = [next(pf) for _ in range(3)]
        bench_input.drain(pf)
        after = next(pf)
    finally:
        pf.close()
    for k, batch in enumerate(got):
        _assert_batches_equal(batch, make_batch(fn.ds, cfg, rnd_state=k,
                                                augmentation=fn.aug))
    assert after["images"].shape == got[0]["images"].shape


def test_bench_input_line_and_fields():
    cfg, fn = bench_input.make_fn(SIZE, VIEWS, uint8=True)
    line = bench_input.measure("thread", fn, cfg, 2, 3)
    assert json.loads(json.dumps(line)) == line
    assert line["metric"] == "host_input_pipeline" and line["uint8"]
    assert line["workers"] == 2 and line["image_size"] == SIZE
    assert line["batches_per_sec"] > 0
    assert line["view_images_per_sec"] == pytest.approx(
        line["frames_per_sec"] * VIEWS, rel=1e-3)


class _Failing:
    def __call__(self, seed):
        raise ValueError(f"no batch at seed {seed}")


def test_a_worker_error_surfaces_as_prefetch_error():
    """The thread worker's sentinel survives the drain and raises on the
    next batch; a process worker's error (after its 5 consecutive
    failures) raises PrefetchError, from the drain or the next batch."""
    pf = BatchPrefetcher(_Failing(), num_threads=1, prefetch=8)
    try:
        pf._queue.put(pf._queue.get())     # the sentinel has arrived
        bench_input.drain(pf)
        with pytest.raises(PrefetchError, match="no batch at seed"):
            next(pf)
    finally:
        pf.close()
    pf = bench_input.prefetcher("process", _Failing(), 1)
    try:
        with pytest.raises(PrefetchError, match="no batch at seed"):
            pf._conns[0].poll(60)
            bench_input.drain(pf)
            next(pf)
    finally:
        pf.close()
