"""Data parallelism over processes and the process prefetcher, on the CPU.

* `parallel/distributed.py::init_distributed` is a no-op (False) for a
  single process and refuses a half-given cluster; with CUDA faked, the
  backend and the GPU each process takes on two 8-GPU hosts (flags,
  torchrun, SLURM), on the CPU, and with processes sharing a GPU; the
  CLI's processes run on their local GPUs.
* Two gloo processes (`torch.multiprocessing` spawn), one conv3d train
  step at batch 1 each, with TRAIN_BN off and on: the ranks end
  bit-equal, and (in float64) equal to the port's single-process batch-2
  step on the same two scenes and ROI priorities (losses within 1e-5
  relative, gradients within 1e-4 and updated parameters and statistics
  within 1e-5 of each tensor's largest value). The two scenes hold different
  numbers of positive anchors, so a mean of per-rank means would not be
  the global loss: the losses' global denominators are what makes it
  match. The oracle is the JAX package's (tests/test_multihost.py): the
  single-process step on the concatenated batch.
* `cli/interior_multi.py train --coordinator ... --num-processes 2` in two
  subprocesses on the CPU: both exit 0, only rank 0 writes a checkpoint
  and metrics.jsonl, and the checkpoint loads.
* `data/generator.py::ProcessPrefetcher` with spawned workers: the k-th
  batch equals make_batch(seed + k) bit for bit; a make_fn that always
  raises gives PrefetchError with its traceback; a SIGKILLed worker
  gives PrefetchError; close() leaves no live child.
"""

import functools
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from mulit_view_object_detection_torch.cli import interior_multi as cli  # noqa: E402
from mulit_view_object_detection_torch.cli.export_synthetic_interiornet import (  # noqa: E402
    export_subset)
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.config import Config  # noqa: E402
from mulit_view_object_detection_torch.data.generator import (  # noqa: E402
    PrefetchError, ProcessPrefetcher, make_batch)
from mulit_view_object_detection_torch.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset)
from mulit_view_object_detection_torch.kernels import unproject  # noqa: E402
from mulit_view_object_detection_torch.models.layers import (  # noqa: E402
    set_compute_dtype)
from mulit_view_object_detection_torch.parallel import (  # noqa: E402
    data_parallel_group, host_local_batch_slice, init_distributed)
from mulit_view_object_detection_torch.train.optim import (  # noqa: E402
    make_optimizer)
from mulit_view_object_detection_torch.train.step import (  # noqa: E402
    train_step)
from mulit_view_object_detection_torch.train.trainable import (  # noqa: E402
    trainable_mask)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLUSTER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID",
                "SLURM_LOCALID", "LOCAL_WORLD_SIZE")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class DPSlice(Config):
    """2 views at 128^2, ResNet-50 with the fork's 5-block stage 4, conv3d
    on an 8^3 grid at every level, a global batch of 2."""
    NAME = "torch_dp_slice"
    NUM_CLASSES = 4
    NUM_VIEWS = 2
    GPU_COUNT = 2
    BACKBONE = "resnet50"
    RESNET50_STAGE4_BLOCKS = 5
    TOP_DOWN_PYRAMID_SIZE = 16
    FPN_CLASSIF_FC_LAYERS_SIZE = 32
    IMAGE_MIN_DIM = IMAGE_MAX_DIM = 128
    RPN_ANCHOR_SCALES = (16, 32, 64, 128, 256)
    PRE_NMS_LIMIT = 256
    POST_NMS_ROIS_TRAINING = 128
    TRAIN_ROIS_PER_IMAGE = 16
    MAX_GT_INSTANCES = 4
    RPN_TRAIN_ANCHORS_PER_IMAGE = 64
    ZERO_PG_LEVELS = ()
    nvox = nvox_z = 8
    vmin, vmax = -2.0, 2.0
    vmin_z, vmax_z = 1.0, 5.0
    samples = 4


DATA_SEED = 3       # two different scenes, with 4 and 5 positive anchors


def _host_batch(cfg):
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=2,
                                   image_size=128, num_classes=4, seed=0)
    return make_batch(ds, cfg, rnd_state=DATA_SEED)


def _step(train_bn, group, dtype):
    """One train step of the port's engine model from seeded weights on
    the batch's rows of this rank (all rows without a group), computing
    in `dtype`. Returns the metrics, gradients, parameters and statistics
    after it."""
    cfg = DPSlice()
    cfg.TRAIN_BN = train_bn
    eng = MaskRCNN("training", cfg, "unused", device="cpu")
    eng.init_weights(torch.Generator().manual_seed(3))
    model = eng.model.to(dtype)
    set_compute_dtype(model, dtype)
    model.compute_dtype = dtype
    host = _host_batch(cfg)
    rows = host_local_batch_slice(cfg.BATCH_SIZE)
    local = {k: v if k == "anchors" else v[rows] for k, v in host.items()}
    batch = {k: v.to(dtype) if v.dtype == torch.float32 else v
             for k, v in eng.to_device(local).items()}
    mask = trainable_mask(model, "all")
    opt = make_optimizer(model.parameters(), cfg.LEARNING_RATE,
                         cfg.LEARNING_MOMENTUM)
    metrics = train_step(model, opt, batch, cfg, mask,
                         torch.Generator().manual_seed(0), group)
    return {"metrics": metrics,
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


# the two ranks' steps: (TRAIN_BN, dtype); float64 for the comparison
# with one process (see test_two_gloo_ranks_match_single_process_batch)
CASES = ((False, torch.float64), (True, torch.float64),
         (True, torch.float32))


def _dp_rank(rank, port, outdir):
    torch.set_num_threads(1)
    # the plain geometry gathers run in float64 on the CPU; the wrappers'
    # check is the kernels' (float32, bfloat16)
    unproject._check_device = lambda t, what: None
    assert init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        group = data_parallel_group()
        assert group is not None
        for i, (train_bn, dtype) in enumerate(CASES):
            torch.save(_step(train_bn, group, dtype),
                       os.path.join(outdir, f"rank{rank}_{i}.pt"))
    finally:
        dist.destroy_process_group()


def test_init_distributed_single_process(monkeypatch):
    """No flags and no cluster environment: False, nothing initialised,
    the whole batch local. A half-given cluster raises."""
    for key in _CLUSTER_ENV:
        monkeypatch.delenv(key, raising=False)
    assert init_distributed() is False
    assert not dist.is_initialized() and data_parallel_group() is None
    assert host_local_batch_slice(4) == slice(0, 4)
    assert init_distributed("127.0.0.1:1", 1, 0) is False
    with pytest.raises(ValueError, match="together"):
        init_distributed("127.0.0.1:1", 2)
    with pytest.raises(ValueError, match="process id"):
        init_distributed("127.0.0.1:1", 2, 2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed()
    assert not dist.is_initialized()


# (flags, environment, GPUs on each host, device, backend asked) ->
# (backend, current GPU); two hosts of 8 GPUs and 16 processes unless said
LAYOUTS = {
    "flags_2_hosts": (("10.0.0.1:29500", 16, 11), {}, 8, "cuda", None,
                      "nccl", 3),
    "flags_cpu": (("10.0.0.1:29500", 16, 11), {}, 8, "cpu", None,
                  "gloo", None),
    "flags_shared_gpu_gloo": (("10.0.0.1:29500", 2, 1), {}, 1, "cuda",
                              "gloo", "gloo", 0),
    "torchrun_2_hosts": ((None, None, None), {
        "WORLD_SIZE": "16", "RANK": "13", "LOCAL_RANK": "5",
        "LOCAL_WORLD_SIZE": "8"}, 8, "cuda", None, "nccl", 5),
    "torchrun_2_on_1_gpu": ((None, None, None), {
        "WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1",
        "LOCAL_WORLD_SIZE": "2"}, 1, "cuda", None, "gloo", 0),
    "slurm_2_nodes": ((None, None, None), {
        "SLURM_NTASKS": "16", "SLURM_PROCID": "9", "SLURM_LOCALID": "1",
        "SLURM_NTASKS_PER_NODE": "8"}, 8, "cuda", None, "nccl", 1),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_init_distributed_backend_and_gpu_by_layout(layout, monkeypatch):
    """The backend and the GPU each process takes, with CUDA faked: NCCL
    and the local rank's GPU across hosts, whether the processes come
    from the flags, torchrun or SLURM; gloo on the CPU, where asked, and
    where the launcher puts more processes on a host than it has GPUs,
    each process then on a GPU all the same."""
    flags, env, gpus, device, backend, want_backend, want_gpu = \
        LAYOUTS[layout]
    for key in _CLUSTER_ENV + ("SLURM_NTASKS_PER_NODE",):
        monkeypatch.delenv(key, raising=False)
    if env:
        env = dict(env, MASTER_ADDR="10.0.0.1", MASTER_PORT="29500")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    placed, groups = [], []
    monkeypatch.setattr(torch.cuda, "set_device", placed.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: groups.append((backend, kw)))
    assert init_distributed(*flags, backend=backend, device=device)
    (got_backend, kw), = groups
    assert got_backend == want_backend
    assert kw["init_method"] == "tcp://10.0.0.1:29500"
    world = int(flags[1] or env.get("WORLD_SIZE") or env["SLURM_NTASKS"])
    assert kw["world_size"] == world
    assert placed == ([] if want_gpu is None
                      else [torch.device("cuda", want_gpu)])


def test_cli_places_each_process_on_its_gpu(monkeypatch):
    """`interior_multi` with the multi-process flags on CUDA (faked): the
    process with id 11 of two 8-GPU hosts runs on cuda:3 over NCCL;
    `--device cpu` stays on the CPU, over gloo."""
    for key in _CLUSTER_ENV + ("SLURM_NTASKS_PER_NODE",):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    backends = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: backends.append(backend))
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 11)
    monkeypatch.setattr(dist, "destroy_process_group", lambda: None)
    seen = []
    monkeypatch.setattr(cli, "cmd_train",
                        lambda args: seen.append(args.device))
    flags = ["train", "--dataset", "unused", "--coordinator",
             "10.0.0.1:29500", "--num-processes", "16", "--process-id", "11"]
    for extra in ([], ["--device", "cpu"]):
        cli.main(flags + extra)
    assert seen == ["cuda:3", "cpu"] and backends == ["nccl", "gloo"]


def test_two_gloo_ranks_match_single_process_batch(tmp_path, monkeypatch):
    """The 2-rank step against the single-process batch-2 step, in
    float64 with TRAIN_BN off and on: losses within 1e-5, gradients within
    1e-4 and updated parameters and statistics within 1e-5 of each
    tensor's largest value. The ranks bit-equal in each case, float32
    with TRAIN_BN included, where the losses are held within 1e-4.

    Why float64: batch-1 and batch-2 convolutions round differently, and
    TRAIN_BN's backward amplifies float32 rounding (its gradients differ
    from float64 ones by up to 0.5% of a tensor's largest value at this
    size, tests/test_torch_train_options.py), so in float32 the two
    steps agree only to rounding, not to the bar."""
    monkeypatch.setattr(unproject, "_check_device", lambda t, what: None)
    host = _host_batch(DPSlice())
    positives = [int((m == 1).sum()) for m in host["rpn_match"]]
    assert positives[0] != positives[1], positives
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, port, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    for i, (train_bn, dtype) in enumerate(CASES):
        ranks = [torch.load(tmp_path / f"rank{r}_{i}.pt") for r in range(2)]
        assert ranks[0]["metrics"] == ranks[1]["metrics"]
        for key in ("grads", "state"):
            for n, t in ranks[0][key].items():
                assert torch.equal(t, ranks[1][key][n]), (i, key, n)
        ref, got = _step(train_bn, None, dtype), ranks[0]
        rel = 1e-5 if dtype == torch.float64 else 1e-4
        for k, v in ref["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=rel), (i, k)
        if dtype != torch.float64:
            continue
        floor = 1e-6 * max(float(g.abs().max())
                           for g in ref["grads"].values())
        for n, g in ref["grads"].items():
            err = float((got["grads"][n] - g).abs().max())
            assert err <= 1e-4 * max(float(g.abs().max()), floor), (i, n)
        # a conv bias before a batch-statistics BatchNorm has a zero
        # gradient: it moves by rounding alone, so it is held at the floor
        floor = 1e-6 * max(float(t.abs().max())
                           for t in ref["state"].values())
        moved = 0
        for n, t in ref["state"].items():
            err = float((got["state"][n] - t).abs().max())
            assert err <= 1e-5 * max(float(t.abs().max()), floor), \
                (i, n, err)
            moved += n.endswith("running_var") and not torch.equal(
                t, torch.ones_like(t))
        assert bool(moved) == train_bn


SMALL = ("IMAGE_MIN_DIM=64,IMAGE_MAX_DIM=64,TOP_DOWN_PYRAMID_SIZE=8,"
         "FPN_CLASSIF_FC_LAYERS_SIZE=16,RPN_ANCHOR_SCALES=(8, 16, 32, 64, "
         "128),PRE_NMS_LIMIT=64,POST_NMS_ROIS_TRAINING=16,"
         "TRAIN_ROIS_PER_IMAGE=8,MAX_GT_INSTANCES=3,"
         "RPN_TRAIN_ANCHORS_PER_IMAGE=32,COMPUTE_DTYPE=float32,nvox=4,"
         "nvox_z=4,samples=2,ZERO_PG_LEVELS=(),STEPS_PER_EPOCH=1,"
         "VALIDATION_STEPS=1,GPU_COUNT=2")


def test_cli_trains_on_two_processes(tmp_path):
    """Two `cli/interior_multi.py train` processes meet at a coordinator
    (gloo, --device cpu) and take one step and one validation step at
    64^2: both exit 0, rank 0 alone writes its checkpoint and
    metrics.jsonl (each rank has its own --logs), and the checkpoint
    loads."""
    root = str(tmp_path / "synthnet")
    for subset, seed in (("train", 21), ("val", 521)):
        export_subset(root, subset, num_scenes=1, seed=seed, image_size=64,
                      num_views=6, obj_px=(12.0, 24.0))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for key in _CLUSTER_ENV:
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "mulit_view_object_detection_torch.cli.interior_multi", "train",
         "--dataset", os.path.join(root, "HD7"),
         "--logs", str(tmp_path / f"logs{rank}"), "--device", "cpu",
         "--epochs", "1,1,1", "--overrides", SMALL,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "epoch 1:" in out and "val_loss=" in out
    # every rank reports the global losses
    lines = [[ln for ln in out.splitlines() if ln.startswith("epoch 1:")]
             for out, _ in outs]
    assert lines[0] == lines[1]

    def written(rank):
        found = []
        for dirpath, _, files in os.walk(tmp_path / f"logs{rank}"):
            found += [os.path.join(dirpath, f) for f in files]
        return found
    assert written(1) == []
    files = written(0)
    assert sum(f.endswith("metrics.jsonl") for f in files) == 1
    assert sum(f.endswith("state.pt") for f in files) == 1
    cfg = cli._apply_overrides(cli.InteriorNetConfig(), SMALL)
    eng = MaskRCNN("training", cfg, str(tmp_path / "logs0"), device="cpu")
    eng.load_weights(eng.find_last())
    assert eng.epoch == 1


# ---------------------------------------------------------------------------
# ProcessPrefetcher
# ---------------------------------------------------------------------------

class PrefetchConfig(Config):
    NAME = "torch_prefetch"
    NUM_CLASSES = 4
    NUM_VIEWS = 2
    IMAGE_MIN_DIM = IMAGE_MAX_DIM = 64
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)
    MAX_GT_INSTANCES = 3


def _prefetch_inputs():
    return (SyntheticMultiViewDataset(num_scenes=2, num_views=2,
                                      image_size=64, num_classes=4, seed=0),
            PrefetchConfig())


def _always_fails(seed):
    raise RuntimeError(f"no batch for seed {seed}")


def test_process_prefetcher_batches_bit_equal_to_make_batch():
    ds, cfg = _prefetch_inputs()
    pf = ProcessPrefetcher(functools.partial(make_batch, ds, cfg),
                           num_procs=2, seed=10)
    try:
        for k in range(5):
            got, want = next(pf), make_batch(ds, cfg, 10 + k)
            assert set(got) == set(want)
            for key, v in want.items():
                assert got[key].dtype == v.dtype, key
                assert np.array_equal(got[key], v), (k, key)
    finally:
        pf.close()
    assert not any(p.is_alive() for p in pf._procs)


def test_process_prefetcher_reports_a_failing_make_fn():
    pf = ProcessPrefetcher(_always_fails, num_procs=1)
    try:
        with pytest.raises(PrefetchError, match="no batch for seed") as info:
            next(pf)
        assert "Traceback" in str(info.value)
    finally:
        pf.close()
    assert not any(p.is_alive() for p in pf._procs)


def test_process_prefetcher_reports_a_killed_worker():
    ds, cfg = _prefetch_inputs()
    pf = ProcessPrefetcher(functools.partial(make_batch, ds, cfg),
                           num_procs=2, seed=0)
    try:
        next(pf)
        os.kill(pf._procs[1].pid, signal.SIGKILL)
        t = time.monotonic()
        with pytest.raises(PrefetchError, match="worker 1"):
            for _ in range(50):
                next(pf)
        assert time.monotonic() - t < 15
    finally:
        pf.close()
    assert not any(p.is_alive() for p in pf._procs)
