"""The port's serving path (serve/batcher.py, serve/http_server.py,
cli/serve.py, cli/serve_bench.py), mirroring tests/test_serve.py: the
MicroBatcher against a fake engine (full batches, padding, a failing
engine, concurrent submitters, signatures, closing), the HTTP endpoint,
the real CPU engine behind the batcher, and the wire protocol across the
two packages (the JAX client against the port's server and the other
way round).

Tolerances: behind the batcher the engine runs the same batch as a
direct detect, so class ids are equal and boxes and scores within 1e-5
(the bar of tests/test_serve.py:185-190); across the wire the arrays
come back bit for bit.
"""

import os
import subprocess
import sys
import threading
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import json  # noqa: E402

from mulit_view_object_detection_tpu import serve as jax_serve  # noqa: E402
from mulit_view_object_detection_tpu.cli import serve as jax_cli  # noqa: E402
from mulit_view_object_detection_torch.cli import serve as cli  # noqa: E402
from mulit_view_object_detection_torch.cli import serve_bench  # noqa: E402
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.serve import (  # noqa: E402
    MicroBatcher, detect_remote, make_server)
from tests.test_torch_bn_fold import fold_config  # noqa: E402
from tests.test_torch_convert import random_variables  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeEngine:
    """tests/test_serve.py's: records each call's images; each result is
    tagged with its image's mean."""

    def __init__(self, fail_times=0, delay=0.0):
        self.calls = []
        self.fail_times = fail_times
        self.delay = delay

    def detect(self, images, Rcam=None, Kmat=None, depths=None):
        self.calls.append([np.asarray(im).copy() for im in images])
        if self.fail_times > 0:
            self.fail_times -= 1
            raise RuntimeError("boom")
        if self.delay:
            time.sleep(self.delay)
        return [{"tag": float(np.asarray(im).mean())} for im in images]


class DictEngine(FakeEngine):
    """A fake engine with detect()'s result keys, for the HTTP tests."""

    def detect(self, images, Rcam=None, Kmat=None, depths=None):
        self.calls.append(len(images))
        out = []
        for im in images:
            v = float(np.asarray(im).mean())
            out.append({"rois": np.full((1, 4), v, np.float32),
                        "class_ids": np.array([int(v)], np.int32),
                        "scores": np.array([0.9], np.float32),
                        "masks": np.zeros((8, 8, 1), np.float32)})
        return out


def _views(val, hw=8):
    return np.full((2, hw, hw, 3), val, np.float32)


@pytest.mark.parametrize("n,batch,delay_ms,want_batches,want_padded", [
    (4, 4, 200, 1, 0),           # a full batch dispatches once
    (1, 4, 10, 1, 3),            # a short batch is padded
], ids=["full_batch", "padded"])
def test_fixed_batches(n, batch, delay_ms, want_batches, want_padded):
    """Every engine call is the fixed batch size; a short batch is padded
    with copies of its first request and the padding's results are
    dropped."""
    eng = FakeEngine()
    with MicroBatcher(eng, batch_size=batch, max_delay_ms=delay_ms) as mb:
        futures = [mb.submit(_views(i + 7)) for i in range(n)]
        results = [f.result(timeout=10) for f in futures]
    assert [r["tag"] for r in results] == [float(i + 7) for i in range(n)]
    s = mb.stats()
    assert s["requests"] == s["completed"] == n
    assert s["batches"] == want_batches
    assert s["padded_slots"] == want_padded
    assert [len(c) for c in eng.calls] == [batch] * want_batches
    for pad in eng.calls[0][n:]:
        np.testing.assert_array_equal(pad, eng.calls[0][0])


def test_engine_failure_fails_that_batch_only():
    eng = FakeEngine(fail_times=1)
    with MicroBatcher(eng, batch_size=2, max_delay_ms=5) as mb:
        f1 = mb.submit(_views(1))
        with pytest.raises(RuntimeError, match="boom"):
            f1.result(timeout=10)
        f2 = mb.submit(_views(2))
        assert f2.result(timeout=10)["tag"] == 2.0


def test_concurrent_submitters_all_resolve():
    """More submitting threads than cores, with a short switch interval:
    every request resolves to its own result, every engine call is the
    fixed batch, and the counters lose no update."""
    eng = FakeEngine()
    results = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with MicroBatcher(eng, batch_size=4, max_delay_ms=20) as mb:
            def worker(i):
                results[i] = mb.submit(_views(i)).result(timeout=30)["tag"]
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert results == {i: float(i) for i in range(32)}
    s = mb.stats()
    assert s["requests"] == s["completed"] == 32
    assert all(len(c) == 4 for c in eng.calls)
    assert s["batches"] == len(eng.calls)
    assert s["padded_slots"] == 4 * s["batches"] - 32


def test_requests_batch_only_with_their_signature():
    """A request whose fields or shapes differ waits for a batch of its
    own instead of joining (and breaking) another's."""
    eng = FakeEngine()
    with MicroBatcher(eng, batch_size=2, max_delay_ms=300) as mb:
        f_small = mb.submit(_views(1))
        f_big = mb.submit(_views(2, hw=16))
        f_kmat = mb.submit(_views(3), Kmat=np.eye(3, dtype=np.float32)[None])
        f_small2 = mb.submit(_views(4))
        tags = [f.result(timeout=10)["tag"]
                for f in (f_small, f_big, f_kmat, f_small2)]
    assert tags == [1.0, 2.0, 3.0, 4.0]
    for call in eng.calls:
        assert len({im.shape for im in call}) == 1
    assert sorted(c[0].shape[1] for c in eng.calls) == [8, 8, 16]
    assert mb.stats()["batches"] == 3


def test_close_serves_pending_and_fails_late_submits():
    """close() lets the dispatcher serve what is queued, the requests set
    aside for their signature too, then fails any later submit instead of
    stranding it."""
    eng = FakeEngine(delay=0.05)
    mb = MicroBatcher(eng, batch_size=2, max_delay_ms=1)
    futures = [mb.submit(_views(i, hw=16 if i == 2 else 8))
               for i in range(5)]
    mb.close()
    assert [f.result(timeout=10)["tag"] for f in futures] == [
        0.0, 1.0, 2.0, 3.0, 4.0]
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(_views(9))
    assert not mb._thread.is_alive()


def _serve(engine, batch_size, max_delay_ms, make=make_server):
    server, batcher = make(engine, port=0, batch_size=batch_size,
                           max_delay_ms=max_delay_ms)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, batcher, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, batcher):
    server.shutdown()
    server.server_close()
    batcher.close()


def test_http_round_trip_and_batching():
    """Concurrent HTTP clients share engine calls and get their own
    results back; /stats counts them and /healthz answers."""
    eng = DictEngine()
    server, batcher, url = _serve(eng, 4, 500)
    try:
        rcam = np.zeros((1, 2, 3, 4), np.float32)
        kmat = np.eye(3, dtype=np.float32)[None]
        results = {}

        def client(i):
            results[i] = detect_remote(url, _views(i), Rcam=rcam, Kmat=kmat,
                                       timeout=30)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert set(results) == {0, 1, 2, 3}
        for i, r in results.items():
            assert int(r["class_ids"][0]) == i
            assert r["rois"].shape == (1, 4)
        assert len(eng.calls) < 4
        with urlopen(f"{url}/stats", timeout=10) as resp:
            assert json.loads(resp.read())["requests"] == 4
        with urlopen(f"{url}/healthz", timeout=10) as resp:
            assert resp.read() == b"ok"
        with pytest.raises(HTTPError) as err:
            urlopen(Request(f"{url}/detect", data=b"not an npz"), timeout=10)
        assert err.value.code == 500
        with pytest.raises(HTTPError) as err:
            urlopen(f"{url}/nowhere", timeout=10)
        assert err.value.code == 404
    finally:
        _stop(server, batcher)


def test_port_client_talks_to_a_jax_server():
    """The port's detect_remote against the JAX package's make_server."""
    eng = DictEngine()
    server, batcher, url = _serve(eng, 1, 1, make=jax_serve.make_server)
    try:
        r = detect_remote(url, _views(5), timeout=30)
    finally:
        _stop(server, batcher)
    assert int(r["class_ids"][0]) == 5
    np.testing.assert_array_equal(r["rois"], np.full((1, 4), 5, np.float32))


@pytest.fixture(scope="module")
def served():
    """A CPU engine with the serving options on (FOLD_BN,
    UINT8_IMAGE_TRANSFER) at FoldCfg's size, batch 2, seeded weights, and
    two scenes with their poses."""
    cfg = fold_config("conv3d", DETECTION_MIN_CONFIDENCE=0.0, FOLD_BN=True,
                      UINT8_IMAGE_TRANSFER=True, IMAGES_PER_GPU=2)
    engine = MaskRCNN("inference", cfg, "serve_logs", device="cpu")
    engine.load_flax_variables(random_variables(cfg, seed=11))
    rng = np.random.RandomState(3)
    scenes = [(rng.rand(cfg.NUM_VIEWS, 64, 64, 3) * 255).astype(np.uint8)
              for _ in range(2)]
    rcam = np.zeros((1, cfg.NUM_VIEWS, 3, 4), np.float32)
    rcam[:, :, :3, :3] = np.eye(3)
    rcam[:, 1, 0, 3] = 0.3
    kmat = np.array([[[40.0, 0, 32], [0, 40.0, 32], [0, 0, 1]]], np.float32)
    direct = engine.detect(scenes, Rcam=np.concatenate([rcam, rcam]),
                           Kmat=np.concatenate([kmat, kmat]))
    return engine, scenes, rcam, kmat, direct


def test_real_engine_microbatched_matches_direct(served):
    """The port's engine behind the batcher equals a direct batched
    detect of the same scenes."""
    engine, scenes, rcam, kmat, direct = served
    with MicroBatcher(engine, batch_size=2, max_delay_ms=500) as mb:
        futures = [mb.submit(s, Rcam=rcam, Kmat=kmat) for s in scenes]
        batched = [f.result(timeout=600) for f in futures]
    assert len(direct[0]["class_ids"]) >= 1
    for d, b in zip(direct, batched):
        np.testing.assert_array_equal(d["class_ids"], b["class_ids"])
        np.testing.assert_allclose(d["scores"], b["scores"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(d["rois"], b["rois"], rtol=1e-5,
                                   atol=1e-5)


def test_jax_client_talks_to_the_port_server(served):
    """The JAX package's detect_remote against the port's server gets the
    port's results, bit for bit through the npz protocol."""
    engine, scenes, rcam, kmat, direct = served
    server, batcher, url = _serve(engine, 2, 500)
    try:
        got = {}

        def client(i):
            got[i] = jax_serve.detect_remote(url, scenes[i], Rcam=rcam,
                                             Kmat=kmat, timeout=600)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        _stop(server, batcher)
    assert set(got) == {0, 1}
    for i in range(2):
        assert set(got[i]) == {"rois", "class_ids", "scores", "masks"}
        np.testing.assert_array_equal(got[i]["class_ids"],
                                      direct[i]["class_ids"])
        np.testing.assert_allclose(got[i]["scores"], direct[i]["scores"],
                                   rtol=1e-5, atol=1e-5)
        assert got[i]["masks"].shape[:2] == (64, 64)


def _serve_args(extra=()):
    return cli.parse_args(["--weights", "unused", "--image-size", "64",
                           "--nvox", "8", "--samples", "4",
                           "--pyramid-size", "16", "--num-classes", "4",
                           "--batch", "2", *extra])


def test_cli_build_config_sets_what_the_jax_cli_sets():
    """cli/serve.py's ServeConfig equals the JAX command line's for the
    same arguments (FOLD_BN, bfloat16, the 5-block stage 4, ...), and the
    port accepts it."""
    args = _serve_args()
    got = cli.build_config(args).to_dict()
    want = jax_cli.build_config(args).to_dict()
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert got["FOLD_BN"] and got["COMPUTE_DTYPE"] == "bfloat16"
    assert got["BATCH_SIZE"] == 2 and got["RESNET50_STAGE4_BLOCKS"] == 5
    assert cli.parse_args(["--weights", "w"]).device == "cuda"


def test_cli_engine_answers_a_post(tmp_path):
    """An engine built by cli/serve.py on the CPU from a checkpoint the
    port wrote answers one POST /detect; on the card by default, which
    raises without one."""
    args = _serve_args(["--weights", str(tmp_path / "ckpt"),
                        "--device", "cpu"])
    writer = MaskRCNN("inference", cli.build_config(args), str(tmp_path),
                      device="cpu")
    writer.save_weights(str(tmp_path / "ckpt"), step=1)
    engine = cli.build_engine(args)
    assert engine.config.FOLD_BN and engine.epoch == 1
    server, batcher, url = _serve(engine, args.batch, 1)
    try:
        views = np.random.RandomState(0).randint(
            0, 255, (2, 64, 64, 3)).astype(np.uint8)
        r = detect_remote(url, views, timeout=600)
    finally:
        _stop(server, batcher)
    n = len(r["class_ids"])
    assert r["rois"].shape == (n, 4) and r["masks"].shape == (64, 64, n)
    assert np.isfinite(r["scores"]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.build_engine(_serve_args(["--weights", str(tmp_path)]))


def test_serve_bench_measure_counts_batches():
    """cli/serve_bench.measure: a warm-up batch, then every request
    resolved in fixed batches (5 requests at batch 2: 3 batches, one
    padded slot; the counters include the warm-up's batch, as the JAX
    tool's do), with the JAX tool's result fields."""
    class Eng(FakeEngine):
        config = serve_bench.build_config(2, 64)

        def detect(self, images, Rcam=None, Kmat=None, depths=None):
            return [{"class_ids": np.arange(3), **r}
                    for r in super().detect(images, Rcam, Kmat, depths)]
    eng = Eng()
    out = serve_bench.measure(eng, batch=2, requests=5, max_delay_ms=50)
    assert out["metric"] == "serving_requests_per_sec" and out["value"] > 0
    assert (out["batch"], out["requests"]) == (2, 5)
    assert out["batches"] == 4 and out["padded_slots"] == 1
    assert out["image"] == "64^2 x 2 views" and out["mean_detections"] == 3
    assert [len(c) for c in eng.calls] == [2, 2, 2, 2]
    assert eng.config.FOLD_BN and eng.config.COMPUTE_DTYPE == "bfloat16"
    assert serve_bench.card("cpu") == {"device": "cpu"}


def test_port_serves_with_jax_blocked():
    """With jax, flax, optax and the JAX package made unimportable, the
    port's server answers a POST from the port's client."""
    code = """
import importlib.abc
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "mulit_view_object_detection_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import threading
import numpy as np
import torch
torch.set_num_threads(1)
from mulit_view_object_detection_torch.compat import MaskRCNN
from mulit_view_object_detection_torch.config import Config
from mulit_view_object_detection_torch.serve import detect_remote, make_server

class Tiny(Config):
    NAME = "blocked"
    NUM_CLASSES = 3
    NUM_VIEWS = 2
    BACKBONE = "resnet50"
    TOP_DOWN_PYRAMID_SIZE = 8
    FPN_CLASSIF_FC_LAYERS_SIZE = 16
    IMAGE_MIN_DIM = IMAGE_MAX_DIM = 64
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)
    PRE_NMS_LIMIT = 64
    POST_NMS_ROIS_INFERENCE = 16
    DETECTION_MAX_INSTANCES = 4
    DETECTION_MIN_CONFIDENCE = 0.0
    FOLD_BN = True
    UINT8_IMAGE_TRANSFER = True
    nvox = nvox_z = 4
    samples = 2

engine = MaskRCNN("inference", Tiny(), "serve_logs", device="cpu")
server, batcher = make_server(engine, port=0, batch_size=1, max_delay_ms=1)
threading.Thread(target=server.serve_forever, daemon=True).start()
views = np.zeros((2, 64, 64, 3), np.uint8)
r = detect_remote(f"http://127.0.0.1:{server.server_address[1]}", views,
                  timeout=300)
server.shutdown()
batcher.close()
assert set(r) == {"rois", "class_ids", "scores", "masks"}, r
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("SERVED", len(r["class_ids"]))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED" in proc.stdout
