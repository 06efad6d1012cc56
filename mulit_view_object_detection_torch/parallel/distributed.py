"""Data parallelism over processes with torch.distributed.

The port of the data-parallel half of
`mulit_view_object_detection_tpu/parallel/mesh.py`: `init_distributed`
(mesh.py:176-221) and `host_local_batch_slice` (mesh.py:224-231). Under
the JAX package's pjit the global batch is one array and XLA inserts the
collectives; here each rank holds its share of the batch, and the code
that needs the global batch reduces over the process group explicitly:

  * TRAIN_BN's batch statistics (`models/resnet.py::BatchStats`, through
    the differentiable `all_reduce_sum`), so that they are the global
    batch's;
  * the losses' denominators (`models/losses.py`), so that each rank's
    loss is its share of the global loss;
  * the gradients (`all_reduce_gradients`) and the reported losses
    (`train/step.py`).

The rest of mesh.py, the view and model axes, is `parallel/mesh.py`,
which re-exports `init_distributed` and `host_local_batch_slice`.
"""

from __future__ import annotations

import datetime
import itertools
import os

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2 ** 20      # gradients all-reduced in one call
TIMEOUT = datetime.timedelta(minutes=10)


def _cluster_env():
    """(world size, rank, "host:port") from a launcher's environment:
    torchrun's WORLD_SIZE / RANK / MASTER_ADDR / MASTER_PORT, or SLURM's
    SLURM_NTASKS / SLURM_PROCID beside MASTER_ADDR / MASTER_PORT;
    (1, 0, None) when there is none."""
    env = os.environ
    if "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", 0))
    elif "SLURM_NTASKS" in env:
        world, rank = int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"])
    else:
        return 1, 0, None
    if world > 1 and not ("MASTER_ADDR" in env and "MASTER_PORT" in env):
        raise ValueError(
            f"the environment names {world} processes but no MASTER_ADDR "
            f"and MASTER_PORT for them to meet at")
    return world, rank, f"{env.get('MASTER_ADDR')}:{env.get('MASTER_PORT')}"


def local_world_size():
    """The number of processes on this host as the launcher says it:
    LOCAL_WORLD_SIZE (torchrun) or SLURM_NTASKS_PER_NODE; None when no
    launcher says (the explicit flags)."""
    for key in ("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE"):
        if key in os.environ:
            return int(os.environ[key])
    return None


def local_rank(rank=None):
    """This process's index among the processes of its host: LOCAL_RANK
    (torchrun) or SLURM_LOCALID, else the rank modulo the GPUs here (the
    explicit flags number each host's processes in a row)."""
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        if key in os.environ:
            return int(os.environ[key])
    rank = dist.get_rank() if rank is None else rank
    return rank % max(torch.cuda.device_count(), 1)


def local_device(device="cuda", rank=None):
    """This process's device for a run on `device`: the CPU, or a CUDA
    device with an index, as given; `cuda` the GPU of the local rank,
    modulo the GPUs here (so processes that share GPUs share them
    evenly), whatever the backend."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None \
            or not torch.cuda.is_available():
        return device
    return torch.device("cuda", local_rank(rank) % torch.cuda.device_count())


def default_backend(device="cuda"):
    """NCCL for a run on CUDA, gloo for the CPU (or without CUDA). gloo
    too when the launcher puts more processes on this host than it has
    GPUs (`local_world_size`), since NCCL refuses two ranks on one GPU.
    With the explicit flags nothing says how many processes share a
    host, so NCCL: one process a GPU is its layout, and a shared GPU
    fails at NCCL's first collective; such a run names gloo."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    local = local_world_size()
    if local is not None and local > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, device="cuda"):
    """Join the process group of a data-parallel run; call it before the
    engine is built. The processes come from the explicit arguments (all
    three: "host:port" of rank 0, their number and this one's rank) or a
    launcher's environment (torchrun, SLURM). Returns True when a group
    of more than one process is up, False (and does nothing) for a
    single process. `device` is the run's: `backend` defaults to
    `default_backend(device)`, and on CUDA the process takes
    `local_device(device)` as its current GPU under either backend.
    Failures raise: a wrong address or a rank that never arrives ends in
    torch.distributed's error after TIMEOUT, never in a silent
    single-process run."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError("the coordinator's address, the number of "
                             "processes and the process id go together")
        world, rank = int(num_processes), int(process_id)
        address = coordinator_address
        if not 0 <= rank < world:
            raise ValueError(f"process id {rank} is not in [0, {world})")
    else:
        world, rank, address = _cluster_env()
    if world <= 1:
        return False
    backend = backend or default_backend(device)
    place = local_device(device, rank)
    if place.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(place)
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return True


def data_parallel_group():
    """The default process group when more than one process is in it,
    else None (a single process reduces nothing)."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def host_local_batch_slice(global_batch_size):
    """This process's rows of the global batch."""
    group = data_parallel_group()
    n = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    if global_batch_size % n:
        raise ValueError(f"a global batch of {global_batch_size} "
                         f"(BATCH_SIZE = IMAGES_PER_GPU * GPU_COUNT) does "
                         f"not split over {n} processes")
    per = global_batch_size // n
    return slice(rank * per, rank * per + per)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """The sum of `x` over the ranks of `group`, on every rank,
    differentiable: the sum reaches every rank's loss, so its gradient
    on each rank is the sum of the ranks' gradients."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_gradients(params, group):
    """Sum the gradients of `params` that require one over the ranks of
    `group` (a missing gradient counts as zeros), in buckets: each
    bucket's gradients are flattened into one buffer, all-reduced in one
    call and copied back. Every rank must pass the same parameters in the
    same order."""
    grads = []
    for p in params:
        if p.requires_grad:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    _in_buckets(grads, lambda flat: dist.all_reduce(flat, group=group))


@torch.no_grad()
def broadcast_tensors(tensors, group):
    """Make `tensors` (the same list on every rank of `group`) the
    group's first rank's, in buckets as `all_reduce_gradients`."""
    src = dist.get_global_rank(group, 0)
    _in_buckets(tensors, lambda flat: dist.broadcast(flat, src=src,
                                                     group=group))


def _in_buckets(tensors, collective):
    """Run `collective` on the tensors flattened into buffers of about
    BUCKET_BYTES each (one dtype a buffer), copying the results back."""
    bucket, size = [], 0
    for t in tensors:
        if bucket and t.dtype != bucket[0].dtype:
            _run_bucket(bucket, collective)
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel() * t.element_size()
        if size >= BUCKET_BYTES:
            _run_bucket(bucket, collective)
            bucket, size = [], 0
    if bucket:
        _run_bucket(bucket, collective)


def _run_bucket(bucket, collective):
    flat = torch.cat([t.reshape(-1) for t in bucket])
    collective(flat)
    offset = 0
    for t in bucket:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def broadcast_module(module, group):
    """Make every rank's parameters and buffers rank 0's of `group`."""
    src = dist.get_global_rank(group, 0)
    for t in itertools.chain(module.parameters(), module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
