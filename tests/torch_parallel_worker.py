"""The port's training steps in a data-parallel world and in one process,
for tests/test_torch_port_parallel.py.

Imports no JAX: the spawned ranks import this module. ``run_world`` is the
body of each spawned gloo rank: it joins the world through a ``file://``
store, runs every case's step on its rows of the case's global batch
(``world_step``) and saves what it ends with; the test process runs the
same cases in one process on the joined batch (``local_step``) and holds
the two against each other, and the JAX cases against JAX's sharded step.
"""

import time

import numpy as np
import torch

B = 8            # global batch: 4 two-view samples a rank in a world of 2
IMG = 32
NC = 3
# the phases of the JAX cases: (trainable labels, align_w, tanh_w,
# class_w, pretrain, finetune)
LABELS = ("backbone", "to_freeze", "to_train", "add_on", "cls_weight",
          "cls_bias", "intermediate")
PHASES = {"pretrain": ({"to_train", "to_freeze", "add_on"}, 0.5, 5.0, 0.0,
                       1.0, 0.0),
          "joint": (set(LABELS), 5.0, 2.0, 2.0, 0.0, 0.0)}
LR = 1e-2
CLASS_WEIGHTS = (0.5, 1.0, 2.0)
COUNT = ["--model", "count_pipnet", "--net", "convnext_tiny_26",
         "--use_mid_layers", "--num_stages", "2", "--num_features", "4",
         "--max_count", "3", "--use_ste", "True", "--intermediate_layer",
         "onehot", "--backward_clamp_strategy", "Identity",
         "--tanh_loss_coeff", "0.1"]
# case: (flags, phase, class weights, device augmentation)
CASES = {
    **{f"jax_{ph}_{'weighted' if w else 'plain'}":
       (COUNT + ["--activation", "softmax"], ph, w, False)
       for ph in PHASES for w in (False, True)},
    "gumbel_drawn": (COUNT + ["--activation", "gumbel_softmax"], "joint",
                     False, False),
    "device_augment": (COUNT + ["--activation", "gumbel_softmax",
                                "--device_augment", "--device_geometric",
                                "--dataset", "geometric_shapes_gaussian_noise"],
                       "joint", False, True),
    "resnet18": (["--model", "pipnet", "--net", "resnet18",
                  "--num_features", "8"], "joint", False, False),
    # the ResNet-18 trunk alone in float64 (its gradients through the
    # world's BatchNorm statistics; in float32 a BatchNorm trunk at its
    # init is too ill-conditioned to compare, as test_torch_port_resnet.py
    # finds)
    "resnet18_trunk_f64": (["--model", "pipnet", "--net", "resnet18",
                            "--num_features", "8"], "joint", False, False),
}
JAX_CASES = [c for c in CASES if c.startswith("jax_")]


def args_of(case):
    from count_pipnet_tpu_torch.config import build_parser
    flags = CASES[case][0] + ["--image_size", str(IMG), "--seed", "3",
                              "--dtype", "float32", "--disable_cuda",
                              "--disable_pretrained", "--weight_decay",
                              "0.0", "--log_dir", "unused"]
    return build_parser().parse_args(flags)


def batch_of(case):
    """The global batch: two float views and labels, or with the device
    augmentation uint8 canvases and labels (numpy seed)."""
    rng = np.random.default_rng(7)
    ys = np.arange(B) % NC
    if CASES[case][3]:
        return (rng.integers(0, 256, (B, IMG + 32, IMG + 32, 3),
                             dtype=np.uint8), ys)
    views = [rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
             for _ in range(2)]
    return views[0], views[1], ys


def trainer_of(case, weights=None):
    """The case's Trainer (in a world, on the world's mesh), its stochastic
    depth raised to 0.5 a block so that the masks show; ``weights``: a
    state dict to load (the JAX cases' parameters)."""
    from count_pipnet_tpu_torch.train.trainer import Trainer
    tr = Trainer(args_of(case), NC)
    if weights is not None:
        tr.model.load_state_dict(weights)
    blocks = getattr(tr.model.backbone, "blocks", None)
    for blk in (blocks() if blocks else []):
        blk.sd_prob = 0.5
    return tr


def sched_of(case):
    _, aw, tw, cw, pre, fin = PHASES[CASES[case][1]]
    return {"lr": dict.fromkeys(LABELS, LR), "align_w": aw, "tanh_w": tw,
            "class_w": cw, "pretrain": pre, "finetune": fin, "tau": 0.8,
            "project": 0.0 if pre else 1.0}


def trunk_step(tr, batch, shard=None):
    """The float64 trunk's gradients (every parameter) under a fixed
    random loss sum(features * w) over both views, summed over the world;
    its BatchNorm statistics move. Returns the loss (the world's)."""
    trunk = tr.model.backbone.double()
    trunk.requires_grad_(True)
    x = torch.cat([torch.as_tensor(t) for t in batch[:2]]).double()
    w = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2 * B, IMG // 8, IMG // 8, trunk.out_channels)))
    if shard is not None:
        w = shard.take(w)
    loss = (trunk(x, train=True, shard=shard) * w).sum()
    loss.backward()
    if shard is None:
        return {"loss": loss.item()}
    from count_pipnet_tpu_torch.parallel.mesh import all_reduce_grads
    all_reduce_grads(trunk.parameters(), tr.mesh)
    return {"loss": float(tr.mesh.sum_values({"loss": loss})["loss"])}


def step(case, tr, batch, shard=None):
    """One optimizer step of ``tr`` on ``batch`` (this rank's rows in a
    world): the JAX cases with every stochastic-depth mask kept (JAX's
    masks are patched to ones), the others with the masks and the noise
    drawn from the trainer's generators. Returns the metrics as floats."""
    from count_pipnet_tpu_torch.data.device_augment import \
        make_device_twoview_augment
    from count_pipnet_tpu_torch.data.registry import device_augment_config
    from count_pipnet_tpu_torch.train.optim import masks_of, set_trainable
    from count_pipnet_tpu_torch.train.steps import train_step
    if case == "resnet18_trunk_f64":
        from count_pipnet_tpu_torch.parallel.mesh import BatchShard
        return trunk_step(tr, batch, shard and BatchShard(tr.mesh, 2))
    _, phase, weighted, augment = CASES[case]
    set_trainable(tr.model, tr.labels, masks_of(PHASES[phase][0]))
    if augment:
        xs, ys = batch
        cfg = device_augment_config(tr.args)
        xs1, xs2 = make_device_twoview_augment(cfg)(
            tr.aug_generator, torch.as_tensor(xs), shard)
    else:
        xs1, xs2, ys = (torch.as_tensor(t) for t in batch)
    masks = None
    if case in JAX_CASES:
        masks = [torch.ones(2 * len(ys), 1, 1, 1)
                 for _ in tr.model.backbone.blocks()]
    m = train_step(tr.model, tr.optimizer, (xs1, xs2, torch.as_tensor(ys)),
                   sched_of(case), is_count_pipnet=tr.is_count,
                   tanh_loss_coeff=tr.args.tanh_loss_coeff,
                   class_weights=torch.tensor(CLASS_WEIGHTS)
                   if weighted else None,
                   generator=tr.generator, drop_masks=masks,
                   mesh=tr.mesh if shard is not None else None)
    return {k: float(v) for k, v in m.items()}


def result(tr, metrics):
    return {"metrics": metrics,
            "state": {k: v.detach().clone()
                      for k, v in tr.model.state_dict().items()},
            "grads": {n: p.grad.clone() for n, p in
                      tr.model.named_parameters() if p.grad is not None}}


def local_step(case, weights=None):
    """The case's one-process step on the joined batch, with the state it
    started from (``init``)."""
    tr = trainer_of(case, weights)
    init = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    return dict(result(tr, step(case, tr, batch_of(case))), init=init)


def world_step(case, weights=None):
    """The case's step on this rank's rows of the global batch."""
    from count_pipnet_tpu_torch.parallel.mesh import BatchShard, shard_batch
    tr = trainer_of(case, weights)
    assert tr.mesh.distributed and tr.mesh.size == 2
    batch = shard_batch(tr.mesh, batch_of(case))
    return result(tr, step(case, tr, batch, BatchShard(tr.mesh)))


def run_world(rank, world_size, store, out, weights_path):
    """A spawned rank: every case's world step; rank r saves its results
    to ``out``.<r>."""
    from count_pipnet_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    distributed.maybe_initialize(init_method=f"file://{store}",
                                 world_size=world_size, rank=rank,
                                 device_type="cpu")
    try:
        weights = torch.load(weights_path)
        res = {case: world_step(case, weights.get(case)) for case in CASES}
        torch.save(res, f"{out}.{rank}")
    finally:
        distributed.shutdown()


class World:
    """:func:`run_world` on ``world_size`` spawned gloo ranks, started
    here and left running; :meth:`results` waits for them and returns
    each rank's results."""

    def __init__(self, tmp_path, weights, world_size=2):
        torch.save(weights, tmp_path / "weights.pt")
        self.paths = [tmp_path / f"world.{r}" for r in range(world_size)]
        self.context = torch.multiprocessing.start_processes(
            run_world, args=(world_size, str(tmp_path / "store"),
                             str(tmp_path / "world"),
                             str(tmp_path / "weights.pt")),
            nprocs=world_size, join=False, start_method="spawn")
        self._results = None

    def results(self, timeout=300.0):
        if self._results is None:
            deadline = time.monotonic() + timeout
            while not self.context.join(timeout=5.0):
                if time.monotonic() > deadline:
                    for p in self.context.processes:
                        p.kill()
                    raise TimeoutError(f"the world's ranks ran past "
                                       f"{timeout} s")
            self._results = [torch.load(p) for p in self.paths]
        return self._results
