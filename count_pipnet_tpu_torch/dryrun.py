"""Multi-rank dry run: one full training step of a world of n gloo ranks on
the CPU, at tiny shapes.

The counterpart of the root ``__graft_entry__.py: dryrun_multichip`` (one
jitted training step over an n-device mesh): n spawned processes join a
gloo world through a ``file://`` store, build the shapes experiments'
graph (a 3-stage mid-layer ``convnext_tiny_26``, 16 prototypes, 9 classes,
Gumbel activation) at 32x32, and take one step of every group with
drawn noise and stochastic depth on 4 two-view samples a rank. Every rank
must end with the same finite loss and parameters.

    python -m count_pipnet_tpu_torch.dryrun [n]      # default 2
"""

import os
import shutil
import sys
import tempfile

import numpy as np
import torch

__all__ = ["dryrun_multichip"]

PER_RANK = 4   # two-view samples a rank
IMG = 32
FLAGS = ["--model", "count_pipnet", "--net", "convnext_tiny_26",
         "--use_mid_layers", "--num_stages", "3", "--num_features", "16",
         "--max_count", "3", "--use_ste", "True", "--activation",
         "gumbel_softmax", "--intermediate_layer", "onehot",
         "--tanh_loss_coeff", "0.1", "--image_size", str(IMG), "--dtype",
         "float32", "--disable_cuda", "--disable_pretrained", "--seed", "0",
         "--log_dir", "unused"]


def _rank(rank, n, store, out):
    from .config import build_parser
    from .parallel import distributed
    from .parallel.mesh import shard_batch
    from .train.optim import masks_of, set_trainable
    from .train.steps import train_step
    from .train.trainer import Trainer
    torch.set_num_threads(1)
    distributed.maybe_initialize(init_method=f"file://{store}",
                                 world_size=n, rank=rank, device_type="cpu")
    try:
        tr = Trainer(build_parser().parse_args(FLAGS), 9)
        set_trainable(tr.model, tr.labels, masks_of(set(tr.labels.values())))
        rng = np.random.default_rng(1)
        b = PER_RANK * n
        xs1, xs2 = (torch.from_numpy(rng.normal(size=(b, IMG, IMG, 3))
                                     .astype(np.float32)) for _ in range(2))
        batch = shard_batch(tr.mesh, (xs1, xs2, torch.arange(b) % 9))
        sched = {"lr": dict.fromkeys(
            ("backbone", "to_freeze", "to_train", "add_on", "cls_weight",
             "cls_bias", "intermediate"), 1e-3), "align_w": 1.0,
            "tanh_w": 1.0, "class_w": 1.0, "pretrain": 0.0, "finetune": 0.0,
            "tau": 1.0, "project": 1.0}
        m = train_step(tr.model, tr.optimizer, batch, sched,
                       tanh_loss_coeff=0.1, generator=tr.generator,
                       mesh=tr.mesh)
        flat = torch.cat([p.detach().reshape(-1)
                          for p in tr.model.parameters()])
        torch.save({"loss": float(m["loss"]), "params": flat},
                   f"{out}.{rank}")
    finally:
        distributed.shutdown()


def dryrun_multichip(n_devices: int = 2) -> float:
    """One full training step on ``n_devices`` spawned gloo CPU ranks;
    prints ``dryrun_multichip(n): OK, loss=...`` and returns the loss."""
    tmp = tempfile.mkdtemp(prefix="cpt_dryrun_")
    try:
        out = os.path.join(tmp, "rank")
        torch.multiprocessing.start_processes(
            _rank, args=(n_devices, os.path.join(tmp, "store"), out),
            nprocs=n_devices, start_method="spawn")
        res = [torch.load(f"{out}.{r}") for r in range(n_devices)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loss = res[0]["loss"]
    assert np.isfinite(loss), f"non-finite loss {loss}"
    for r in res[1:]:
        assert r["loss"] == loss and torch.equal(r["params"],
                                                 res[0]["params"]), \
            "the ranks' steps diverged"
    print(f"dryrun_multichip({n_devices}): OK, loss={loss:.4f}")
    return loss


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
