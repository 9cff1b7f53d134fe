"""The port's training against the JAX package's: the parameter groups,
a six-step trajectory of the train step, and evaluation.

* ``label_params`` (port names) equals the JAX package's ``label_params``
  on the bridged parameter tree, for the full ConvNeXt-Tiny net and for
  mid-layer nets.
* Six steps of ``train.steps.train_step`` against ``make_train_step``:
  the same parameters through the bridge, the same batches, the same
  injected Gumbel noise and stochastic-depth masks, across the pretrain
  masks, the finetune masks and the unfrozen main masks (with the
  classifier projection), on the eager, the ``--fused_blocks``, the
  ``--fused_whole_blocks`` and the ``--fused_dwconv`` routes.
  Losses and final parameters within the stated tolerances; frozen
  parameters bit-unchanged.
* One step's gradients under the flagship's phases (pretraining, the
  frozen-trunk main masks), in f32 equal to the JAX package's, in bf16
  no farther from f32 than the JAX package's bf16 gradients.
* ``train.eval.evaluate`` against the JAX ``evaluate`` on the same
  parameters, batches and noise, including the destructive weight shrink.
Small widths; inputs from numpy seeds."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu.models.pipnet import CountPIPNet as JCountPIPNet
from count_pipnet_tpu.models.virtual_weights import \
    calculate_virtual_weights as j_virtual_weights
from count_pipnet_tpu.ops.losses import calculate_loss as j_calculate_loss
from count_pipnet_tpu.train import eval as jeval
from count_pipnet_tpu.train.optim import adamw_init
from count_pipnet_tpu.train.optim import label_params as j_label_params
from count_pipnet_tpu.train.steps import make_train_step
from count_pipnet_tpu_torch.models.convert import (from_jax_params, jax_path,
                                                   to_jax_params)
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.pipnet import (CountPIPNet,
                                                  get_count_network)
from count_pipnet_tpu_torch.models.virtual_weights import \
    calculate_virtual_weights
from count_pipnet_tpu_torch.train.eval import evaluate
from count_pipnet_tpu_torch.train.optim import (label_params, make_optimizer,
                                                masks_of, set_trainable)
from count_pipnet_tpu_torch.train.steps import train_step

STAGES = ((32, 1), (64, 1), (64, 2), (96, 1))
NUM_STAGES = 5          # stem, stage 1, down, stage 2, down, stage 3
P, NC, M, B = 8, 5, 3, 4
LAT = 7                 # 64 px -> 16 -> 8 (stride 2) -> 7 (stride 1)
COEFF = 0.1


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("use_mid_layers,num_stages", [(False, 7),
                                                       (True, 3), (True, 5)])
def test_label_groups_match_label_params(use_mid_layers, num_stages):
    class Args:
        net = "convnext_tiny_26"
        num_features = 16

    Args.use_mid_layers, Args.num_stages = use_mid_layers, num_stages
    with torch.device("meta"):  # names only, no weights to draw
        model, _ = get_count_network(10, Args, max_count=3)
    ours = label_params(model, Args.net, use_mid_layers, num_stages)
    tree = {}
    for name in ours:  # the flax tree's structure, one leaf per parameter
        path = jax_path(name)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.zeros(1)
    theirs = j_label_params(tree, Args.net, use_mid_layers=use_mid_layers,
                            num_stages=num_stages)
    for name, label in ours.items():
        assert _lookup(theirs, jax_path(name)) == label, name
    want = {"backbone", "to_freeze", "to_train", "add_on", "cls_weight",
            "frozen"}
    assert set(ours.values()) == want


def _models(fused, activation="gumbel_softmax", intermediate="onehot",
            dtype=jnp.float32, **routes):
    """The flax and the port's model on the same parameters; ``fused``
    sets ``fused_mlp``, ``routes`` the other block-route flags, ``dtype``
    the flax model's compute dtype (the port's comes from the step)."""
    jm = JCountPIPNet(
        num_classes=NC, num_prototypes=P, max_count=M,
        backbone=JFeatures(stage_settings=STAGES, stride_threshold=40,
                           num_stages=NUM_STAGES, fused_mlp=fused,
                           dtype=dtype, **routes),
        num_features=P, activation=activation,
        intermediate_type=intermediate, dtype=dtype)
    params = jax.device_get(jm.init(
        {"params": jax.random.PRNGKey(5), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)))["params"])
    rng = np.random.default_rng(8)
    bb = {k: (dict(v, layer_scale=np.full_like(v["layer_scale"], 0.2))
              if "layer_scale" in v else v)
          for k, v in params["backbone"].items()}
    clf = {"weight": (1.0 + 0.1 * rng.normal(
        size=params["classification"]["weight"].shape)).astype(np.float32),
        "multiplier": np.full((1,), 2.0, np.float32)}
    params = dict(params, backbone=bb, classification=clf)
    tm = CountPIPNet(num_classes=NC, num_prototypes=P, max_count=M,
                     backbone=ConvNeXtFeatures(STAGES, 40, NUM_STAGES,
                                               fused_mlp=fused, **routes),
                     num_features=P, activation=activation,
                     intermediate_type=intermediate)
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm


def _noise_and_masks(tm, seed):
    rng = np.random.default_rng(seed)
    noise = rng.gumbel(size=(2 * B, LAT, LAT, P)).astype(np.float32)
    masks = [(rng.random((2 * B, 1, 1, 1)) < 1 - b.sd_prob)
             for b in tm.backbone.blocks()]
    return noise, masks


def _patch(monkeypatch, noise, masks):
    """JAX draws at trace time: the jitted step bakes this noise and these
    masks in, so every step of both sides uses the same ones."""
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(noise, dtype))
    cycle = itertools.cycle(masks[1:])  # block 0 has no stochastic depth
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(next(cycle)))


LR = {"backbone": 2e-4, "to_freeze": 3e-4, "to_train": 3e-4,
      "add_on": 3e-3, "cls_weight": 5e-3, "cls_bias": 5e-3,
      "intermediate": 5e-3}
# phase: (trainable labels, align_w, tanh_w, class_w, pretrain, finetune)
PHASES = [("pretrain", {"to_train", "to_freeze", "add_on"},
           0.5, 5.0, 0.0, 1.0, 0.0),
          ("finetune", {"cls_weight", "cls_bias", "intermediate"},
           5.0, 2.0, 2.0, 0.0, 1.0),
          ("main", set(LR), 5.0, 2.0, 2.0, 0.0, 0.0)]


def _sched(phase):
    _, trainable, aw, tw, cw, pre, fin = phase
    return {"lr": dict(LR), "align_w": aw, "tanh_w": tw, "class_w": cw,
            "pretrain": pre, "finetune": fin, "tau": 0.8,
            "project": 0.0 if pre else 1.0}, masks_of(trainable)


@pytest.mark.parametrize("fused", [False, True])
def test_trajectory_matches_make_train_step(monkeypatch, fused):
    """Losses to 1e-5 relative (eager) / 1e-4 (fused: the JAX XLA body
    rounds its GEMM results to bf16, the port's plain K5 does not).
    Final parameters, against how far each tensor moved: eager, every
    entry within 1 % of the largest move; fused, the difference's norm
    within 10 % of the move's norm (gradients that differ at 1e-3 make
    AdamW move the few entries whose gradient is nearly zero by +-lr)."""
    _check_trajectory(monkeypatch, fused, *_models(fused))


@pytest.mark.parametrize("route", ["fused_whole_blocks", "fused_dwconv"])
def test_trajectory_new_routes(monkeypatch, route):
    """The same six steps on the whole-block route (kernel A's plain
    version forward, the recompute backward; the tolerances of the fused
    route: the JAX XLA body rounds its GEMM results to bf16) and on the
    depthwise route (K7's plain version forward, PyTorch's conv backward,
    the eager body: the eager tolerances)."""
    flags = {"fused_whole_blocks": dict(fused_whole_block=True),
             "fused_dwconv": dict(fused_dwconv=True)}[route]
    _check_trajectory(monkeypatch, route == "fused_whole_blocks",
                      *_models(False, **flags))


def _check_trajectory(monkeypatch, fused, jm, params, tm,
                      train_intermediate=True, move_norm=None):
    """Six steps of both train steps; ``fused``: the loose tolerances;
    ``train_intermediate``: the --train_intermediate flag of both label
    rules; ``move_norm``: instead of the per-entry bound of the eager
    route, each final tensor's difference norm within ``move_norm`` of
    its move's norm. Returns the port's initial state dict."""
    noise, masks = _noise_and_masks(tm, 21)
    _patch(monkeypatch, noise, masks)
    labels_j = j_label_params(params, "convnext_tiny_26",
                              use_mid_layers=True, num_stages=NUM_STAGES,
                              train_intermediate=train_intermediate)
    step_j = make_train_step(jm, labels_j, is_count_pipnet=True,
                             enforce_weight_sparsity=True,
                             tanh_loss_coeff=COEFF, donate=False)
    opt_j = adamw_init(params)
    labels = label_params(tm, "convnext_tiny_26", use_mid_layers=True,
                          num_stages=NUM_STAGES,
                          train_intermediate=train_intermediate)
    opt = make_optimizer(tm, labels)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    noise_t = torch.from_numpy(noise)
    masks_t = [torch.from_numpy(m.astype(np.float32)) for m in masks]
    rng = np.random.default_rng(4)
    losses_j, losses_t = [], []
    pj = params
    for phase in PHASES:
        sched, masks_on = _sched(phase)
        sched_j = {k: ({kk: jnp.float32(vv) for kk, vv in v.items()}
                       if isinstance(v, dict) else jnp.float32(v))
                   for k, v in sched.items()}
        sched_j["mask"] = {k: jnp.float32(v) for k, v in masks_on.items()}
        set_trainable(tm, labels, masks_on)
        for _ in range(2):
            x1, x2 = (rng.normal(size=(B, 64, 64, 3)).astype(np.float32)
                      for _ in range(2))
            ys = rng.integers(0, NC, size=B)
            pj, _, opt_j, met = step_j(pj, {}, opt_j,
                                       (x1, x2, ys.astype(np.int32)),
                                       jax.random.PRNGKey(0), sched_j)
            losses_j.append(float(met["loss"]))
            met_t = train_step(tm, opt, (torch.from_numpy(x1),
                                         torch.from_numpy(x2),
                                         torch.from_numpy(ys)), sched,
                               tanh_loss_coeff=COEFF, noise=noise_t,
                               drop_masks=masks_t)
            losses_t.append(met_t["loss"].item())
        if phase[0] == "finetune":
            # the early backbone has been frozen in both phases so far
            for name, label in labels.items():
                if label == "backbone":
                    assert torch.equal(tm.state_dict()[name], init[name])
    np.testing.assert_allclose(losses_t, losses_j,
                               rtol=1e-4 if fused else 1e-5)
    assert torch.equal(tm.classification.normalization_multiplier,
                       init["classification.normalization_multiplier"])
    final = to_jax_params(tm.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(pj)[0]:
        names = tuple(k.key for k in path)
        leaf = np.asarray(leaf)
        diff = _lookup(final, names) - leaf
        moved = leaf - np.asarray(_lookup(params, names))
        if not moved.any():
            np.testing.assert_array_equal(diff, 0.0, err_msg=str(names))
        elif fused or move_norm:
            limit = move_norm or 0.1
            assert np.linalg.norm(diff) <= limit * np.linalg.norm(moved), \
                names
        else:
            assert np.abs(diff).max() <= 0.01 * np.abs(moved).max(), names
    return init


# the flagship's phases (configs/flagship_200_wide.yaml): pretraining, and
# the main epochs with the trunk frozen (no sparsity projection)
FROZEN_PHASES = {"pretrain": PHASES[0],
                 "frozen main": ("frozen main",
                                 {"to_train", "to_freeze", "add_on",
                                  "intermediate", "cls_weight", "cls_bias"},
                                 5.0, 2.0, 2.0, 0.0, 0.0)}


def _gradients(monkeypatch, dtype, phase):
    """The loss gradient of one --fused_blocks step on both sides in
    ``dtype`` (the flax model's dtype; the port's ``train_step`` autocast
    with zero learning rates, so the step leaves the gradients and not
    the parameters): {flax path: (JAX gradient, port gradient)} of the
    phase's trainable tensors."""
    jm, params, tm = _models(True, dtype=getattr(jnp, dtype))
    noise, masks = _noise_and_masks(tm, 21)
    _patch(monkeypatch, noise, masks)
    sched, masks_on = _sched(FROZEN_PHASES[phase])
    sched["lr"] = {k: 0.0 for k in LR}
    rng = np.random.default_rng(4)
    x1, x2 = (rng.normal(size=(B, 64, 64, 3)).astype(np.float32)
              for _ in range(2))
    ys = rng.integers(0, NC, size=B)

    def loss_fn(p):
        proto, pooled, out = jm.apply(
            {"params": p}, jnp.concatenate([x1, x2]), train=True,
            tau=sched["tau"], rngs={"gumbel": jax.random.PRNGKey(0),
                                    "droppath": jax.random.PRNGKey(1)})
        return j_calculate_loss(
            proto.astype(jnp.float32), pooled.astype(jnp.float32),
            out.astype(jnp.float32), jnp.asarray(ys, jnp.int32),
            sched["align_w"], sched["tanh_w"], sched["class_w"],
            p["classification"]["multiplier"][0], sched["pretrain"],
            sched["finetune"], is_count_pipnet=True,
            enforce_weight_sparsity=False, tanh_loss_coeff=COEFF)[0]

    g_j = jax.device_get(jax.jit(jax.grad(loss_fn))(params))
    labels = label_params(tm, "convnext_tiny_26", use_mid_layers=True,
                          num_stages=NUM_STAGES)
    set_trainable(tm, labels, masks_on)
    train_step(tm, make_optimizer(tm, labels),
               (torch.from_numpy(x1), torch.from_numpy(x2),
                torch.from_numpy(ys)), sched, enforce_weight_sparsity=False,
               tanh_loss_coeff=COEFF, noise=torch.from_numpy(noise),
               drop_masks=[torch.from_numpy(m.astype(np.float32))
                           for m in masks], dtype=dtype)
    g_t = to_jax_params({n: p.grad for n, p in tm.named_parameters()
                         if p.grad is not None})
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(g_t)[0]:
        names = tuple(k.key for k in path)
        out[names] = (np.asarray(_lookup(g_j, names), np.float32),
                      np.asarray(leaf, np.float32))
    return out


@pytest.mark.parametrize("phase", list(FROZEN_PHASES))
def test_bf16_gradients_stay_as_close_to_f32_as_jax(monkeypatch, phase):
    """The flagship's phases on the --fused_blocks route, one step's
    gradients of every trainable tensor. In f32 the port's equal the JAX
    package's to 5e-3 of each tensor's norm. In bf16 (the port's autocast
    against flax's ``dtype=bfloat16``) each side's gradient is held to
    its own f32 gradient: the port's relative errors, their largest and
    their mean over the tensors, are within 1.5 times the JAX package's,
    so the port's bf16 training is about as noisy as the reference's."""
    f32 = _gradients(monkeypatch, "float32", phase)
    bf16 = _gradients(monkeypatch, "bfloat16", phase)
    assert len(f32) >= 20 and f32.keys() == bf16.keys()
    err_j, err_t = [], []
    for names, (g_j, g_t) in f32.items():
        norm = np.linalg.norm(g_j)
        assert np.linalg.norm(g_t - g_j) <= 5e-3 * norm, names
        err_j.append(np.linalg.norm(bf16[names][0] - g_j) / norm)
        err_t.append(np.linalg.norm(bf16[names][1] - g_t) / norm)
    assert max(err_t) <= 1.5 * max(err_j), (max(err_t), max(err_j))
    assert np.mean(err_t) <= 1.5 * np.mean(err_j), (np.mean(err_t),
                                                    np.mean(err_j))


def test_evaluate_matches_jax(monkeypatch):
    """Same parameters, batches and Gumbel noise: the statistics of the
    reference's info dict agree (the means to 1e-6), and the classifier
    weight after the per-batch shrink equals the JAX package's."""
    jm, params, tm = _models(False)
    noise, _ = _noise_and_masks(tm, 22)
    noise = noise[:B]
    _patch(monkeypatch, noise, [None])
    rng = np.random.default_rng(9)
    loader = [(rng.normal(size=(B, 64, 64, 3)).astype(np.float32),
               rng.integers(0, NC, size=B).astype(np.int32))
              for _ in range(2)]
    info_j, params_j = jeval.evaluate(jm, params, {}, loader, 1,
                                      num_classes=NC,
                                      rng=jax.random.PRNGKey(0))
    info_t = evaluate(tm, loader, 1, num_classes=NC,
                      noises=[torch.from_numpy(noise)] * len(loader))
    np.testing.assert_array_equal(info_t["confusion_matrix"],
                                  info_j["confusion_matrix"])
    for k in ("top1_accuracy", "top5_accuracy", "local_size_for_true_class",
              "local_size_for_all_classes", "prototypes_per_class",
              "almost_nonzeros", "num non-zero prototypes", "sparsity_ratio"):
        np.testing.assert_allclose(info_t[k], info_j[k], rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(
        tm.classification.weight.detach().numpy(),
        np.asarray(params_j["classification"]["weight"]), rtol=1e-6)


@pytest.mark.parametrize("scaled", [False, True])
def test_virtual_weights_match_jax(scaled):
    """The virtual [classes, prototypes] matrix, plain and scaled by the
    dataset-mean one-hot features (``custom_onehot_scale``; the softmax
    head keeps the counts deterministic), to 1e-5 relative."""
    jm, params, tm = _models(False, activation="softmax")
    rng = np.random.default_rng(12)
    loader = [(rng.normal(size=(B, 64, 64, 3)).astype(np.float32),
               rng.integers(0, NC, size=B)) for _ in range(2)]
    want = np.asarray(j_virtual_weights(jm, params, {}, loader,
                                        custom_onehot_scale=scaled))
    got = calculate_virtual_weights(tm, loader, custom_onehot_scale=scaled)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
