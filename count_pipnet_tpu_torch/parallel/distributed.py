"""Joining a data-parallel world: one process a device under torch.distributed.

Port of count_pipnet_tpu/parallel/distributed.py. The JAX package connects
one process a host with ``jax.distributed.initialize`` and runs one SPMD
program over every device of the mesh; the port runs one process a device
(a rank), joined by ``torch.distributed``:

* :func:`maybe_initialize` joins a world described by explicit arguments
  or by torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``). A one-process run returns False, so
  every entry point can call it; a second call returns True. A failed
  join raises: there is no fallback to a one-process run.
* The backend is NCCL when the rank's device is CUDA and gloo otherwise.
  ``backend="gloo"`` on CUDA is allowed: gloo's all-reduce and broadcast
  take CUDA tensors, so two ranks can share one card (NCCL refuses that).
* A CUDA rank makes ``cuda:<local_rank>`` its current device before
  anything touches the card: the kernels launch on the current device
  (ops/cuda/__init__.py: stream_ptr).
* Every rank's loader draws the same epoch permutation (keyed by seed and
  epoch) and loads only its :func:`host_batch_slice` of each global batch
  (data/loader.py), so no data crosses between ranks.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["PG_TIMEOUT", "maybe_initialize", "is_initialized",
           "is_distributed", "process_index", "process_count", "device",
           "host_batch_slice", "barrier", "broadcast_one_to_all",
           "comm_device", "shutdown"]

_DEVICE = {}

# The world's collective timeout. Rank 0 alone renders the projection
# visualisations (train/trainer.py: _visualize, and the --interpret suite)
# while the other ranks wait in their next collective. PyTorch's default
# under NCCL (default_pg_nccl_timeout) is 10 minutes, which a large
# projection set's visualisation can outlast; an hour covers it and still
# ends a world that hangs.
PG_TIMEOUT = datetime.timedelta(hours=1)


def maybe_initialize(init_method=None, world_size=None, rank=None,
                     backend=None, local_rank=None, device_type=None) -> bool:
    """Join the world described by the arguments or torchrun's variables.

    ``init_method``: a ``file://`` or ``tcp://`` store (``env://`` when
    ``MASTER_ADDR`` and ``MASTER_PORT`` are set); ``device_type``: "cuda"
    or "cpu" (default: "cuda" where CUDA is available). An explicit
    ``world_size`` of 1 with an ``init_method`` joins a one-rank world,
    which runs every collective; from the environment a world size of 1
    is a one-process run. Returns True when this process is a rank of a
    world, False for a one-process run."""
    if is_initialized():
        return True
    env = os.environ
    explicit = world_size is not None and init_method is not None
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if world_size is None or (world_size <= 1 and not explicit):
        return False
    if rank is None:
        raise ValueError(f"a world of {world_size} ranks needs this "
                         "process's rank (RANK or rank=)")
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if init_method is None:
        if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            raise ValueError("no store for the world: pass init_method= "
                             "or set MASTER_ADDR and MASTER_PORT")
        init_method = "env://"
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device("cpu")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=PG_TIMEOUT)
    _DEVICE["device"] = dev
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_distributed() -> bool:
    """A world of more than one rank."""
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def device():
    """This rank's device (None outside a world)."""
    return _DEVICE.get("device") if is_initialized() else None


def comm_device(t):
    """Where a collective on ``t`` runs: NCCL takes CUDA tensors only, so a
    host tensor goes to the rank's card; gloo takes either."""
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        return _DEVICE["device"]
    return t.device


def host_batch_slice(global_batch: int, pid=None, pcount=None):
    """This rank's (start, stop) of a global batch; the batch must divide
    evenly by the ranks (uneven slices would desynchronize the step)."""
    pid = process_index() if pid is None else pid
    pcount = process_count() if pcount is None else pcount
    if global_batch % pcount:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{pcount} processes")
    per = global_batch // pcount
    return pid * per, (pid + 1) * per


def barrier():
    """Wait for every rank (a no-op outside a world)."""
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[_DEVICE["device"].index])
    else:
        dist.barrier()


def broadcast_one_to_all(x):
    """Rank 0's value of ``x`` (array-like) on every rank, as a numpy
    array (the JAX trainer's ``multihost_utils.broadcast_one_to_all``)."""
    a = np.asarray(x)
    if not is_initialized():
        return a
    t = torch.as_tensor(a.astype(np.uint8) if a.dtype == bool else a)
    t = t.to(comm_device(t))
    dist.broadcast(t, 0)
    return t.cpu().numpy().astype(a.dtype)


def shutdown():
    """Leave the world (a no-op outside one)."""
    if is_initialized():
        dist.destroy_process_group()
    _DEVICE.clear()
