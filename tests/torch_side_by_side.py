"""The two trainers side by side for main-phase steps, at full width, on the
CPU, from one trained state.

A one-off comparison, not a test (pytest does not collect this file). It
builds the port's ``Trainer`` for a config on the CPU: ``torch.manual_seed
(seed)`` before the model is built gives the same initial trunk as the run
on the card. It loads the parameters that a run's first chunk trained
(``scripts/paired_arms.py --export_seed``: ``features.6``, ``features.7``,
the add-on, the intermediate and the classifier in bf16). It bridges that
state to the JAX package's tree (``models/convert.py: to_jax_params``).
Then it runs ``--steps`` steps of the JAX package's ``make_train_step``
and of the port's ``train_step`` with the config's compute dtype on both
sides, and a third trajectory of the JAX package in f32: the distance
between the JAX package's two is the rounding noise that the port's
distance from it is read against. All get the same batches and a fresh
optimizer. The phase is main
epoch 2 of the config: its trainable groups, learning rates, loss weights
and tau = 0.1. Both also get one Gumbel noise tensor and one set of
stochastic-depth masks, drawn by numpy and injected as
``tests/test_torch_port_trajectory.py`` injects them (JAX draws at trace
time, so the jitted step bakes them in). The batches are two-view batches
that the port's device augmentation makes, from a torch seed, out of the
images of ``--data``: a shapes_200 ``dataset`` directory (any number of
images a class, e.g. ``python -m count_pipnet_tpu_torch.data.
generate_shapes --flagship200 --train_samples_per_class 1``).

Per step it prints one JSON line, the three trajectories in the order of
its ``order`` key. Each gives its loss terms and the prototypes present:
those whose count summed over a view's images is at least 1, the mean
of the two views. On the JAX side these come from a
forward on the step's parameters under the same noise. At the end it
prints, for each trained tensor, the port's and the JAX f32 trajectory's
distance from the JAX package's, over how far that tensor moved.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_side_by_side.py \\
        --state seed1_trained_bf16.pt --seed 1 --data <dataset dir> \\
        [--config configs/flagship_200_wide.yaml] [--steps 20] [--batch 8]
"""

import argparse
import glob
import itertools
import json
import os
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from count_pipnet_tpu.models.pipnet import \
    get_count_network as j_count_network  # noqa: E402
from count_pipnet_tpu.train.optim import adamw_init  # noqa: E402
from count_pipnet_tpu.train.optim import \
    label_params as j_label_params  # noqa: E402
from count_pipnet_tpu.train.steps import make_train_step  # noqa: E402
from count_pipnet_tpu_torch.config import get_args  # noqa: E402
from count_pipnet_tpu_torch.data.device_augment import \
    make_device_twoview_augment  # noqa: E402
from count_pipnet_tpu_torch.data.registry import \
    device_augment_config  # noqa: E402
from count_pipnet_tpu_torch.models.convert import to_jax_params  # noqa: E402
from count_pipnet_tpu_torch.train.optim import set_trainable  # noqa: E402
from count_pipnet_tpu_torch.train.trainer import Trainer  # noqa: E402
from count_pipnet_tpu_torch.train.steps import train_step  # noqa: E402

STEPS_PER_EPOCH = 156  # flagship_200_wide: 10,000 images in batches of 64
ORDER = ("jax", "port", "jax_f32")


def _lookup(tree, names):
    for k in names:
        tree = tree[k]
    return tree


def present(pooled):
    """Prototypes present in each view of a two-view batch, averaged."""
    views = np.split(np.asarray(pooled, np.float32), 2)
    return float(np.mean([(v.sum(axis=0) >= 1.0).sum() for v in views]))


def load_images(data, n, seed):
    """``n`` uint8 images of ``data``'s train split and their labels."""
    classes = sorted(os.listdir(os.path.join(data, "train")))  # ImageFolder
    files = [(f, i) for i, c in enumerate(classes)
             for f in sorted(glob.glob(os.path.join(data, "train", c, "*")))]
    pick = np.random.default_rng(seed).choice(len(files), n, replace=False)
    xs = np.stack([np.asarray(Image.open(files[k][0]).convert("RGB"))
                   for k in pick])
    return torch.from_numpy(xs), torch.tensor([files[k][1] for k in pick])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--state", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--data", required=True)
    ap.add_argument("--config", default="configs/flagship_200_wide.yaml")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    opts = ap.parse_args(argv)

    args = get_args(["--config", opts.config, "--seed", str(opts.seed),
                     "--disable_cuda", "--log_dir", tempfile.mkdtemp()])
    tr = Trainer(args, num_classes=200)
    trained = torch.load(opts.state, map_location="cpu", weights_only=True)
    state = tr.model.state_dict()
    assert set(trained) <= set(state), set(trained) - set(state)
    state.update({k: v.float() for k, v in trained.items()})
    tr.model.load_state_dict(state)
    tr.update_temperature(0.1)
    masks, _ = tr.main_masks(2, args.epochs_finetune, args.freeze_epochs)
    set_trainable(tr.model, tr.labels, masks)

    params0 = jax.tree_util.tree_map(jnp.asarray,
                                     to_jax_params(tr.model.state_dict()))
    labels_j = j_label_params(params0, args.net,
                              use_mid_layers=args.use_mid_layers,
                              num_stages=args.num_stages)
    frozen = frozenset(k for k, v in masks.items() if v == 0.0)
    # the JAX package in the config's dtype, and in f32: the distance
    # between those two is the rounding noise the port is held to
    sides = {}
    for name, dtype in (("jax", jnp.bfloat16 if args.dtype == "bfloat16"
                         else jnp.float32), ("jax_f32", jnp.float32)):
        jm, _ = j_count_network(200, args, max_count=args.max_count,
                                use_ste=args.use_ste, dtype=dtype)
        sides[name] = {
            "params": params0, "opt": adamw_init(params0),
            "step": make_train_step(
                jm, labels_j, is_count_pipnet=True,
                enforce_weight_sparsity=args.enforce_weight_sparsity,
                tanh_loss_coeff=args.tanh_loss_coeff, frozen_labels=frozen,
                donate=False),
            "fwd": jax.jit(lambda p, x, tau, jm=jm: jm.apply(
                {"params": p}, x, train=True, tau=tau,
                rngs={"gumbel": jax.random.PRNGKey(0),
                      "droppath": jax.random.PRNGKey(1)})[1])}

    rng = np.random.default_rng(opts.seed)
    b2 = 2 * opts.batch
    side = args.wshape = 26
    noise = rng.gumbel(size=(b2, side, side, tr.num_prototypes)).astype(
        np.float32)
    probs = [b.sd_prob for b in tr.model.backbone.blocks()]
    drops = [(rng.random((b2, 1, 1, 1)) < 1 - p).astype(np.float32)
             for p in probs]
    cycle = itertools.cycle(drops[1:])  # block 0 has no stochastic depth
    jax.random.gumbel = (lambda key, shape, dtype=jnp.float32:
                         jnp.asarray(noise, dtype))
    jax.random.bernoulli = (lambda key, p, shape:
                            jnp.asarray(next(cycle) > 0))
    noise_t = torch.from_numpy(noise)
    drops_t = [torch.from_numpy(d) for d in drops]

    pooled_t = {}
    tr.model.register_forward_hook(
        lambda m, i, out: pooled_t.__setitem__("v", out[1].detach()))

    augment = make_device_twoview_augment(device_augment_config(args))
    images, ys_all = load_images(opts.data, opts.batch * opts.steps,
                                 opts.seed)
    gen = torch.Generator().manual_seed(opts.seed)
    # copies: the numpy views of CPU tensors would follow the updates
    init = to_jax_params({k: v.clone() for k, v in
                          tr.model.state_dict().items()})
    net_sched = {"T": STEPS_PER_EPOCH * args.epochs,
                 "eta_min": args.lr_net / 100.0, "step": STEPS_PER_EPOCH}
    cls_sched = {"T0": 5 if args.epochs <= 30 else 10, "eta_min": 0.001}
    for i in range(opts.steps):
        t0 = time.time()
        sl = slice(i * opts.batch, (i + 1) * opts.batch)
        v1, v2 = augment(gen, images[sl])
        ys = ys_all[sl]
        sched = tr.sched(i, STEPS_PER_EPOCH, 2, pretrain=False,
                         finetune=False, net_sched=net_sched,
                         cls_sched=cls_sched,
                         bb_warmup=(args.freeze_epochs, 0),
                         weights=(5.0, 2.0, 2.0))
        net_sched["step"] += 1
        sched_j = {k: ({kk: jnp.float32(vv) for kk, vv in v.items()}
                       if isinstance(v, dict) else jnp.float32(v))
                   for k, v in sched.items()}
        sched_j["mask"] = {k: jnp.float32(v) for k, v in masks.items()}
        x = jnp.concatenate([jnp.asarray(v1.numpy()),
                             jnp.asarray(v2.numpy())])
        batch = (np.asarray(v1), np.asarray(v2), np.asarray(ys, np.int32))
        met, pres = {}, {}
        for name, sd in sides.items():
            pres[name] = present(sd["fwd"](sd["params"], x, sched["tau"]))
            sd["params"], _, sd["opt"], met[name] = sd["step"](
                sd["params"], {}, sd["opt"], batch, jax.random.PRNGKey(0),
                sched_j)
        met["port"] = train_step(
            tr.model, tr.optimizer, (v1, v2, ys), sched,
            is_count_pipnet=True,
            enforce_weight_sparsity=args.enforce_weight_sparsity,
            tanh_loss_coeff=args.tanh_loss_coeff, noise=noise_t,
            drop_masks=drops_t, dtype=args.dtype)
        pres["port"] = present(pooled_t["v"].numpy())
        row = {"step": i + 1, "seconds": round(time.time() - t0, 1),
               "order": ORDER}
        for k in ("loss", "tanh", "class", "align", "acc"):
            row[k] = [float(met[n][k]) for n in ORDER]
        row["present"] = [pres[n] for n in ORDER]
        print(json.dumps(row), flush=True)

    final = {"port": to_jax_params(tr.model.state_dict()),
             "jax_f32": sides["jax_f32"]["params"]}
    leaves = jax.tree_util.tree_flatten_with_path(sides["jax"]["params"])[0]
    for path, leaf in leaves:
        names = [k.key for k in path]
        leaf = np.asarray(leaf, np.float32)
        start = _lookup(init, names)
        moved = np.linalg.norm(leaf - start)
        if moved == 0.0:
            continue
        row = {"tensor": "/".join(names), "moved": float(moved)}
        for name, tree in final.items():
            d = np.linalg.norm(leaf - np.asarray(_lookup(tree, names),
                                                 np.float32))
            row[f"{name}_diff_over_moved"] = float(d / moved)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
