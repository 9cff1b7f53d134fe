"""The data-parallel world of the port: its devices, the batch split by
rank, replicated state and the collectives of a training step.

Port of count_pipnet_tpu/parallel/mesh.py. The JAX package shards the
global batch over a 1-D mesh, replicates the parameters and optimizer
state, and lets XLA insert the gradient all-reduce. The port runs one
process a device (parallel/distributed.py) and does the same by hand:

* :func:`make_mesh` is the world's device list in rank order, with this
  rank's index; outside a world it is the one device of this process;
* :func:`shard_batch` keeps this rank's rows of a global batch;
* :func:`replicate` broadcasts rank 0's parameters, buffers (BatchNorm
  statistics) and optimizer state;
* :func:`all_reduce_grads` sums the gradients that exist over the ranks,
  in one flat buffer, in the parameters' order. It is explicit rather
  than ``DistributedDataParallel``: the trainer flips ``requires_grad``
  at every phase boundary (train/optim.py: set_trainable), and DDP fixes
  its parameter set when it is built.

The step's contract: a step of an R-rank world on the joined batch equals
the one-process step on that batch. Every rank's loss is its *share*
ℓ_r of the joined batch's loss L (Σ_r ℓ_r = L, ops/losses.py), so the
summed gradients are ∂L/∂θ. Terms that couple the batch (the tanh loss's
batch sum, the weighted class loss, BatchNorm's statistics) read the
world's sums through :meth:`Mesh.all_reduce`, whose backward sums the
cotangents over the ranks (:class:`_AllReduceSum`). The random draws of a
step (Gumbel noise, stochastic-depth masks, the device augmentation's
parameters) are made at the world batch's size from the generator every
rank seeds alike, and each rank keeps its rows (:class:`BatchShard`).
"""

import torch
import torch.distributed as dist

from . import distributed as _dist

__all__ = ["Mesh", "make_mesh", "local_device_count", "check_mesh_size",
           "shard_batch", "replicate", "all_reduce_grads", "BatchShard"]


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_r x_r, the same on every rank.

    Backward: the world's objective is the sum of the ranks' losses
    Σ_r ℓ_r, and each ℓ_r reads its own copy of y, so the cotangent of x_r
    is Σ_r ∂ℓ_r/∂y: the cotangents all-reduced. A term T(y) that every
    rank computes alike therefore enters each rank's loss as T(y) / R; a
    consumer of y that sits on one rank's rows only (BatchNorm's
    normalisation) needs no scaling."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class Mesh:
    """The ranks' devices in rank order and this rank's index.
    ``distributed``: this process is a rank of a torch.distributed world
    (also a world of one rank), so the collectives run."""

    def __init__(self, devices, rank=0, distributed=False):
        self.devices = [torch.device(d) for d in devices]
        self.rank = int(rank)
        self.distributed = bool(distributed)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self):
        return self.devices[self.rank]

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, rank={self.rank}, "
                f"distributed={self.distributed})")

    def all_reduce(self, x):
        """Σ over the ranks of ``x``, with the gradient of
        :class:`_AllReduceSum` (``x`` itself outside a world)."""
        if not self.distributed:
            return x
        dev = _dist.comm_device(x)
        if dev == x.device:
            return _AllReduceSum.apply(x)
        return _AllReduceSum.apply(x.to(dev)).to(x.device)

    @torch.no_grad()
    def sum_values(self, values):
        """{name: 0-d tensor} summed over the ranks in one all-reduce."""
        if not self.distributed or not values:
            return values
        names = list(values)
        flat = torch.stack([values[k].detach().float().reshape(())
                            for k in names])
        flat = self.all_reduce(flat)
        return dict(zip(names, flat.unbind()))


def local_device_count() -> int:
    """The CUDA devices of this machine, or 1 without one."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def check_mesh_size(n_devices: int, available: int):
    """The JAX package's error for a mesh larger than the devices."""
    if n_devices > available:
        raise ValueError(
            f"requested mesh of {n_devices} devices but only "
            f"{available} available")


def make_mesh(n_devices: int = -1, device=None) -> Mesh:
    """The world's mesh. In a world of R ranks: each rank's device
    (gathered once), ``n_devices`` -1 or R. In one process: the one
    ``device`` (default: the current CUDA device; without one it raises:
    the CPU is used only when asked for), ``n_devices`` -1 or 1 (a larger
    mesh runs as that many processes: ``python -m
    count_pipnet_tpu_torch.main --mesh_shape N`` spawns them, torchrun
    starts them). A mesh larger than the CUDA devices, or than
    the world, raises the JAX package's ``ValueError``."""
    if _dist.is_initialized():
        size = _dist.process_count()
        check_mesh_size(n_devices, size)
        if n_devices not in (-1, size):
            raise ValueError(
                f"requested mesh of {n_devices} devices in a world of "
                f"{size} ranks: a rank drives one device, so the mesh is "
                "the world (-1 or the world size)")
        devices = [None] * size
        dist.all_gather_object(devices, str(_dist.device()))
        return Mesh(devices, _dist.process_index(), distributed=True)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh; pass "
                               "device='cpu' to make it on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    available = torch.cuda.device_count() if device.type == "cuda" else 1
    check_mesh_size(n_devices, available)
    if n_devices not in (-1, 1):
        raise ValueError(
            f"a mesh of {n_devices} devices runs as {n_devices} processes: "
            f"start them with python -m count_pipnet_tpu_torch.main "
            f"--mesh_shape {n_devices} or torchrun")
    return Mesh([device])


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch (a tree of arrays or tensors
    with the batch leading); the whole batch outside a world."""
    if mesh.size == 1:
        return batch

    def take(x):
        lo, hi = _dist.host_batch_slice(x.shape[0], mesh.rank, mesh.size)
        return x[lo:hi]

    return _map(take, batch)


def _state_tensors(obj):
    """The tensors :func:`replicate` broadcasts, in a fixed order."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.optim.Optimizer):
        out = []
        for group in obj.param_groups:
            for p in group["params"]:
                st = obj.state.get(p, {})
                out += [st[k] for k in sorted(st)
                        if isinstance(st[k], torch.Tensor)]
        return out
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for o in obj for t in _state_tensors(o)]


@torch.no_grad()
def replicate(mesh: Mesh, *objs):
    """Broadcast rank 0's state into every rank's, in place: modules
    (parameters and buffers), optimizers (their state tensors) and
    tensors. A no-op outside a world."""
    if not mesh.distributed:
        return
    for t in _state_tensors(objs):
        dev = _dist.comm_device(t)
        buf = t.data if dev == t.device else t.data.to(dev)
        dist.broadcast(buf, 0)
        if buf is not t.data:
            t.data.copy_(buf)


@torch.no_grad()
def all_reduce_grads(params, mesh: Mesh):
    """Sum the gradients that exist over the ranks, in one all-reduce of a
    flat buffer (f32, or the gradients' wider type), in ``params``' order
    (every rank holds the same gradients, its own values)."""
    if not mesh.distributed:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    dtype = torch.float32
    for g in grads:
        dtype = torch.promote_types(dtype, g.dtype)
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads])
    flat = mesh.all_reduce(flat)
    i = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[i:i + n].view_as(g))
        i += n


class BatchShard:
    """A rank's rows of the world's batch inside one forward.

    The rank's batch holds ``chunks`` equal chunks (a train step's two
    views), each the rank's slice of the world's chunk, so the world's
    batch is [chunk 0 of rank 0, ..., of rank R-1, chunk 1 of rank 0, ...]:
    the one-process step's batch on the joined data. A draw of the world's
    shape from a generator seeded alike on every rank, cut by
    :meth:`take`, is the one-process draw's rows of this rank."""

    def __init__(self, mesh: Mesh, chunks: int = 1):
        self.mesh = mesh
        self.chunks = int(chunks)

    def world_shape(self, shape):
        """The world's shape of a per-rank ``shape`` (batch leading)."""
        return (shape[0] * self.mesh.size,) + tuple(shape[1:])

    def take(self, t):
        """This rank's rows of a world-shaped ``t``."""
        r, k = self.mesh.size, self.chunks
        per = t.shape[0] // (r * k)
        rows = t.reshape((k, r, per) + tuple(t.shape[1:]))[:, self.mesh.rank]
        return rows.reshape((k * per,) + tuple(t.shape[1:]))

    def all_reduce(self, x):
        return self.mesh.all_reduce(x)
