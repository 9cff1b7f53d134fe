"""Serve a trained run's checkpoint on every gumbel-hard route.

    python3 -m count_pipnet_tpu_torch.scripts.serve_trained \
        --run_dir <run> [--routes bf16 int8_static ...] [--batch_size 64] \
        [--disable_cuda]

The run's ``net_best`` is read by the port's checkpoint code and loaded
into the model its ``metadata/args.pickle`` describes, built with the
block routes off (the module's own f32 ops). The run's whole test split,
read by the port's loader without augmentation and in order, then goes
through four serving routes (models/serving.py: make_gumbel_serving_fn):

* ``bf16``: kernel A in its bf16 mode for every block (``int8_min_dim``
  above the widest block);
* ``int8_static``: static int8 scales from ``calibrate_act_scales`` on 64
  training images drawn without replacement from the whole split with a
  fixed numpy seed (no augmentation; the loader's order is sorted by
  class, so its first 64 images would come from one or two classes);
* ``int8_downsample``: the same with the stride-1 downsamples through K10;
* ``int8_dynamic``: kernel A's dynamic int8 mode (no scales, the default
  ``int8_min_dim`` 384).

With an add-on (``num_features > 0``) every route ends in the add-on's
1x1 conv and K4; without one, in kernel C. Each batch draws one Gumbel
noise tensor with numpy from the fixed ``NOISE_SEED``
(:func:`batch_noise`), and the same tensor goes to
(a) the route's kernels, (b) the same route with every kernel wrapper
swapped for its plain version (models/serving.py:
serving_plain_versions) and (c) the plain f32 eager forward
``model(x, inference=True, noise=noise)`` with TF32 off. Each route prints
one ``[serve]`` JSON line: the card, the launches read around (a), the
counts agreement and logit relative error of (a) against (b) and against
(c) and of (b) against (c), the top-1 agreement of (a) with (c), the test
accuracy of (a), (b) and (c), and whether (a) meets bench.py's bar against
(c) (counts agreement > 0.99, logit relative error < 0.05).

It raises when a kernel the route runs did not launch once a batch
(on the card), or when (a) agrees with (b) below 0.99 in counts: either
is a fault of a kernel. A route under bench.py's bar against (c) is a
reading, not a failure: whether (b) misses the same way tells the
int8 recipe on trained weights from a fault of the port's kernels.
"""

import argparse
import copy
import json
import os
import pickle
import sys
import time
from collections import Counter

import numpy as np
import torch

from . import card_line, checked_device, no_tf32

__all__ = ["ROUTES", "BF16_MIN_DIM", "CAL_IMAGES", "CAL_SEED", "NOISE_SEED",
           "KERNEL_GATE", "BAR", "agreement", "plain_model", "load_run",
           "calibration_indices", "run_data", "route_options",
           "expected_launches", "batch_noise", "serve_routes",
           "serve_trained"]

ROUTES = ("bf16", "int8_static", "int8_downsample", "int8_dynamic")
# above convnext_tiny's widest block (768): every block runs bf16
BF16_MIN_DIM = 769
CAL_IMAGES = 64
# the calibration images' draw and the Gumbel noise's, both with numpy
CAL_SEED = 0
NOISE_SEED = 0
# the kernels against their plain versions, counts agreement
KERNEL_GATE = 0.99
# bench.py:183's bar against the plain f32 eager forward
BAR = {"counts_agree": 0.99, "logit_rel_err": 0.05}


def agreement(c, o, c_ref, o_ref):
    """(clamped counts agreement, logit relative error) of one run against
    another."""
    return ((c == c_ref).float().mean().item(),
            ((o - o_ref).abs().max() / (o_ref.abs().max() + 1e-9)).item())


def plain_model(args, num_classes, state_dict=None, device="cpu"):
    """The Count-PIPNet ``args`` describe with the block routes off
    (``--fused_blocks``, ``--fused_whole_blocks``, ``--fused_dwconv``
    change the forward, not the parameters), ``state_dict`` loaded, in
    eval mode on ``device``."""
    from ..models.pipnet import get_count_network
    a = copy.copy(args)
    a.fused_blocks = a.fused_whole_blocks = a.fused_dwconv = False
    model, _ = get_count_network(num_classes, a,
                                 max_count=getattr(a, "max_count", 3),
                                 use_ste=getattr(a, "use_ste", False))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model.to(device).eval()


def load_run(run_dir, device="cuda", checkpoint="net_best"):
    """(model, args, meta) of a trained run: its ``metadata/args.pickle``
    and its checkpoint role (utils/checkpoint.py), as :func:`plain_model`
    on ``device``."""
    from ..utils.checkpoint import CheckpointManager
    with open(os.path.join(run_dir, "metadata", "args.pickle"), "rb") as f:
        args = pickle.load(f)
    args.log_dir = run_dir
    ckpt = CheckpointManager(args)
    res = (ckpt.load_best_checkpoint() if checkpoint == "net_best"
           else ckpt.load_trained_checkpoint(name=checkpoint))
    if res is None:
        raise FileNotFoundError(f"no '{checkpoint}' checkpoint under "
                                f"{run_dir}")
    state, meta = res
    num_classes = state["model"]["classification.weight"].shape[0]
    return plain_model(args, num_classes, state["model"], device), args, meta


def calibration_indices(n):
    """``CAL_IMAGES`` indices of a training split of ``n`` images (all of
    a smaller one), drawn without replacement with numpy from ``CAL_SEED``
    and sorted: every class has its chance, whatever order the split is
    stored in."""
    rng = np.random.default_rng(CAL_SEED)
    return np.sort(rng.choice(n, size=min(CAL_IMAGES, n),
                              replace=False)).tolist()


def run_data(args, batch_size=64, basepath="./"):
    """(test loader, calibration images) of a run's dataset, read by the
    port's loader without augmentation: the whole test split in order in
    batches of ``batch_size``, and the training images of
    :func:`calibration_indices` [N, H, W, 3]. A missing synthetic dataset
    is regenerated first (data/ensure.py)."""
    from ..data.datasets import Subset
    from ..data.loader import DataLoader
    from ..data.registry import get_data, validate_dataset_paths
    validate_dataset_paths(args, basepath)
    data = get_data(args, basepath)
    trainset_normal, testset = data[2], data[5]
    common = dict(shuffle=False, drop_last=False,
                  num_workers=args.num_workers, seed=args.seed)
    cal = Subset(trainset_normal, calibration_indices(len(trainset_normal)))
    x_cal = next(iter(DataLoader(cal, len(cal), **common)))[0]
    return DataLoader(testset, batch_size, **common), x_cal


def route_options(route, act_scales):
    """make_gumbel_serving_fn's options of one route."""
    return {"bf16": {"act_scales": None, "int8_min_dim": BF16_MIN_DIM},
            "int8_static": {"act_scales": act_scales},
            "int8_downsample": {"act_scales": act_scales,
                                "int8_downsample": True},
            "int8_dynamic": {"act_scales": None}}[route]


def expected_launches(backbone, num_features, act_scales=None,
                      int8_min_dim=None, int8_downsample=False):
    """{kernel: launches} of one serving forward on the card, read off the
    weights models/quantized.py: prepare_fused_blocks prepares for it
    (the names of ops/cuda: launch_counts): kernel A a block, as
    ``fused_block_int8_dyn`` in its dynamic mode; the last block as kernel
    C without an add-on, else K4 after the add-on; K10 at each downsample
    it prepared."""
    from ..models.quantized import block_scopes, prepare_fused_blocks
    fused_head = num_features == 0
    prepared = prepare_fused_blocks(backbone, act_scales, int8_min_dim,
                                    fused_head=fused_head,
                                    int8_downsample=int8_downsample)
    scopes = [s for s, *_ in block_scopes(backbone)]
    out = Counter()
    for scope in scopes:
        if fused_head and scope == scopes[-1]:
            out["fused_block_gumbel_counts"] += 1
        elif prepared[scope]["dynamic"]:
            out["fused_block_int8_dyn"] += 1
        else:
            out["fused_block"] += 1
    out["int8_quant_gemm"] += sum(1 for k in prepared if k not in scopes)
    if not fused_head:
        out["gumbel_hard_counts"] += 1
    return {k: v for k, v in out.items() if v}


def batch_noise(index, shape):
    """The Gumbel noise of batch ``index``, [B, H', W', P] float32, drawn
    with numpy from (``NOISE_SEED``, ``index``)."""
    return np.random.default_rng([NOISE_SEED, index]).gumbel(
        size=shape).astype(np.float32)


def _cat(chunks):
    return torch.cat([c.float().cpu() for c in chunks])


def serve_routes(model, batches, x_cal, routes=ROUTES, *, device,
                 keep=False, log=print):
    """Each of ``routes`` on ``batches`` ((images [B, H, W, 3], labels)
    pairs) under one noise tensor a batch, against its plain versions and
    the plain f32 eager forward of ``model`` (a :func:`plain_model`);
    static scales from ``x_cal``. Returns {route: result} (with ``keep``
    also ``"outputs"``: the images, noise, labels and every run's counts
    and logits) and prints one ``[serve]`` line a route; raises as the
    module docstring says."""
    from ..models.quantized import calibrate_act_scales
    from ..models.serving import (make_gumbel_serving_fn,
                                  serving_plain_versions)
    from ..ops import cuda as kernels
    device = torch.device(device)
    model = model.to(device).eval()
    x_cal = torch.as_tensor(x_cal, dtype=torch.float32, device=device)
    with no_tf32():
        scales = calibrate_act_scales(model.backbone, x_cal)
    infers, expected = {}, {}
    for route in routes:
        opts = route_options(route, scales)
        infers[route] = make_gumbel_serving_fn(model, device=device, **opts)
        expected[route] = (expected_launches(model.backbone,
                                             model.num_features, **opts)
                           if device.type == "cuda" else {})
    runs = {(r, k): [] for r in routes for k in ("kernels", "plain")}
    eager, labels, xs_kept, noise_kept = [], [], [], []
    launches = {r: Counter() for r in routes}
    seconds = Counter()
    n_batches = 0
    latent = None
    for i, (x, y) in enumerate(batches):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        if latent is None:
            with torch.no_grad(), no_tf32():
                latent = tuple(model.backbone(x[:1]).shape[1:3])
        noise = torch.from_numpy(batch_noise(
            i, (x.shape[0], *latent, model.num_prototypes))
        ).to(device)
        with torch.no_grad(), no_tf32():
            _, c_r, o_r = model(x, inference=True, noise=noise)
        eager.append((c_r.cpu(), o_r.float().cpu()))
        labels.append(torch.as_tensor(y).cpu())
        if keep:
            xs_kept.append(x.cpu())
            noise_kept.append(noise.cpu())
        for route, infer in infers.items():
            if device.type == "cuda":
                torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            c, o = infer(x, 0, noise=noise)
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds[route] += time.perf_counter() - t0
            launches[route].update({k: v for k, v in
                                    kernels.launch_counts.items() if v})
            runs[(route, "kernels")].append((c.cpu(), o.cpu()))
            with serving_plain_versions():
                c_p, o_p = infer(x, 0, noise=noise)
            runs[(route, "plain")].append((c_p.cpu(), o_p.cpu()))
        n_batches += 1
    if not n_batches:
        raise ValueError("no test images to serve")
    c_r, o_r = _cat(c for c, _ in eager), _cat(o for _, o in eager)
    y = torch.cat(labels)
    acc = lambda o: (o.argmax(1) == y).float().mean().item()  # noqa: E731
    card = card_line() if device.type == "cuda" else "cpu"
    results, faults = {}, []
    for route in routes:
        (c, o), (c_p, o_p) = [
            (_cat(a for a, _ in runs[(route, k)]),
             _cat(b for _, b in runs[(route, k)]))
            for k in ("kernels", "plain")]
        vs_plain = agreement(c, o, c_p, o_p)
        vs_eager = agreement(c, o, c_r, o_r)
        plain_vs_eager = agreement(c_p, o_p, c_r, o_r)
        want = {k: v * n_batches for k, v in expected[route].items()}
        got = dict(launches[route])
        res = {
            "route": route, "card": card, "images": int(y.numel()),
            "batches": n_batches, "launches": got, "expected_launches": want,
            "vs_plain": {"counts_agree": vs_plain[0],
                         "logit_rel_err": vs_plain[1]},
            "vs_eager": {"counts_agree": vs_eager[0],
                         "logit_rel_err": vs_eager[1]},
            "plain_vs_eager": {"counts_agree": plain_vs_eager[0],
                               "logit_rel_err": plain_vs_eager[1]},
            "top1_agree_eager": (o.argmax(1) == o_r.argmax(1)).float()
            .mean().item(),
            "acc": acc(o), "acc_plain": acc(o_p), "acc_eager": acc(o_r),
            "bar_met": (vs_eager[0] > BAR["counts_agree"]
                        and vs_eager[1] < BAR["logit_rel_err"]),
            "plain_bar_met": (plain_vs_eager[0] > BAR["counts_agree"]
                              and plain_vs_eager[1] < BAR["logit_rel_err"]),
            "kernel_s": round(seconds[route], 3)}
        log("[serve] " + json.dumps(res))
        if keep:
            res["outputs"] = {"kernels": (c, o), "plain": (c_p, o_p),
                              "eager": (c_r, o_r), "labels": y,
                              "x": _cat(xs_kept), "noise": _cat(noise_kept)}
        results[route] = res
        missing = {k: (got.get(k, 0), n) for k, n in want.items()
                   if got.get(k, 0) != n}
        if missing:
            faults.append(f"{route}: launches (got, expected) {missing}")
        if vs_plain[0] < KERNEL_GATE:
            faults.append(f"{route}: the kernels agree with their plain "
                          f"versions in {vs_plain[0]:.4f} of the counts, "
                          f"under {KERNEL_GATE}")
    if faults:
        raise RuntimeError("serving the trained model: " + "; ".join(faults))
    return results


def serve_trained(run_dir, routes=ROUTES, device="cuda", *, batch_size=64,
                  basepath="./", keep=False, log=print):
    """Serve ``run_dir``'s ``net_best`` on ``routes`` over its test split
    (see the module docstring). Runs on the card unless ``device`` is the
    CPU, where the kernels' plain versions run. Returns
    :func:`serve_routes`' results."""
    device = checked_device(device)
    t0 = time.perf_counter()
    model, args, meta = load_run(run_dir, device)
    loader, x_cal = run_data(args, batch_size, basepath)
    log(f"[serve] {run_dir}: net_best of epoch {meta.get('epoch')} "
        f"(accuracy {meta.get('accuracy')}), {len(loader.dataset)} test "
        f"images, {len(x_cal)} calibration images")
    results = serve_routes(model, loader, x_cal, routes, device=device,
                           keep=keep, log=log)
    log(f"[serve] {run_dir}: {len(routes)} routes in "
        f"{time.perf_counter() - t0:.1f} s")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--routes", nargs="+", default=list(ROUTES),
                    choices=ROUTES)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--basepath", default="./")
    ap.add_argument("--disable_cuda", action="store_true")
    opts = ap.parse_args(argv)
    serve_trained(opts.run_dir, tuple(opts.routes),
                  "cpu" if opts.disable_cuda else "cuda",
                  batch_size=opts.batch_size, basepath=opts.basepath)
    return 0


if __name__ == "__main__":
    sys.exit(main())
