"""The port's PIP-Net (count_pipnet_tpu_torch/models/pipnet.py: PIPNet)
against the flax ``PIPNet`` on parameters carried across by
``from_jax_params``:

* the forward, in training and at inference (the abstention rule: pooled
  values under 0.1 zeroed before the classifier), within
  tests/test_torch_port_model.py's tolerances;
* ``label_params`` on a PIP-Net tree equal to the JAX package's;
* six steps of ``train_step(is_count_pipnet=False)`` against
  ``make_train_step(is_count_pipnet=False)`` across the pretrain, finetune
  and main masks, on the plain and the ``--fused_blocks`` routes, with
  the tolerances of tests/test_torch_port_trajectory.py;
* ``evaluate`` against the JAX ``evaluate`` (the raw classifier weight as
  the class-prototype weights), the means to 1e-6.
Small widths; inputs from numpy seeds."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu.models.pipnet import PIPNet as JPIPNet
from count_pipnet_tpu.train import eval as jeval
from count_pipnet_tpu.train.optim import adamw_init
from count_pipnet_tpu.train.optim import label_params as j_label_params
from count_pipnet_tpu.train.steps import make_train_step
from count_pipnet_tpu_torch.models.convert import (from_jax_params, jax_path,
                                                   to_jax_params)
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.pipnet import PIPNet, get_pipnet
from count_pipnet_tpu_torch.train.eval import (class_prototype_weights,
                                               evaluate)
from count_pipnet_tpu_torch.train.optim import (label_params, make_optimizer,
                                                masks_of, set_trainable)
from count_pipnet_tpu_torch.train.steps import train_step
from test_torch_port_model import ATOL, RTOL
from test_torch_port_trajectory import (B, LAT, NC, NUM_STAGES, P, PHASES,
                                        STAGES, _lookup, _sched)

COEFF = 0.1  # --tanh_loss_coeff: PIP-Net's step ignores it (coefficient 1)


def _pair(fused=False, seed=5, add_on_bias=0.0):
    """The flax and the port's PIP-Net on the same parameters (layer
    scales 0.2, so every block shows; the trainer's classifier init;
    ``add_on_bias`` added to every other prototype's add-on bias, so that
    a negative one keeps those prototypes under the abstention limit)."""
    jm = JPIPNet(num_classes=NC, num_prototypes=P,
                 backbone=JFeatures(stage_settings=STAGES,
                                    stride_threshold=40,
                                    num_stages=NUM_STAGES, fused_mlp=fused),
                 num_features=P)
    params = jax.device_get(jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(seed), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)))["params"])
    assert set(params) == {"backbone", "add_on", "classification"}
    rng = np.random.default_rng(seed)
    bb = {k: (dict(v, layer_scale=np.full_like(v["layer_scale"], 0.2))
              if "layer_scale" in v else v)
          for k, v in params["backbone"].items()}
    clf = {"weight": (1.0 + 0.1 * rng.normal(
        size=params["classification"]["weight"].shape)).astype(np.float32),
        "multiplier": np.full((1,), 2.0, np.float32)}
    conv = params["add_on"]["conv1x1"]
    add_on = {"conv1x1": dict(conv, bias=conv["bias"] + np.where(
        np.arange(P) % 2 == 0, add_on_bias, 0.0).astype(np.float32))}
    params = dict(params, backbone=bb, classification=clf, add_on=add_on)
    tm = PIPNet(num_classes=NC, num_prototypes=P,
                backbone=ConvNeXtFeatures(STAGES, 40, NUM_STAGES,
                                          fused_mlp=fused),
                num_features=P)
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm


@pytest.mark.parametrize("inference", [False, True])
def test_pipnet_forward_matches_flax(inference):
    """Prototype maps, pooled maxima and logits within RTOL/ATOL; at
    inference some pooled values fall under 0.1 and are zeroed on both
    sides, and every other one passes unchanged."""
    jm, params, tm = _pair(seed=3, add_on_bias=-3.0)
    x = np.random.default_rng(4).normal(size=(B, 64, 64, 3)).astype(
        np.float32)
    proto_j, pooled_j, out_j = jax.jit(
        lambda p, x: jm.apply({"params": p}, x, inference=inference))(
        params, jnp.asarray(x))
    with torch.no_grad():
        proto_t, pooled_t, out_t = tm(torch.from_numpy(x),
                                      inference=inference)
    assert proto_t.shape == (B, LAT, LAT, P)
    np.testing.assert_allclose(proto_t.numpy(), np.asarray(proto_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    maxima = proto_t.amax(dim=(1, 2))
    if inference:
        low = maxima < 0.1
        assert low.any() and (~low).any()
        assert torch.equal(pooled_t[low], torch.zeros(int(low.sum())))
        assert torch.equal(pooled_t[~low], maxima[~low])
    else:
        assert torch.equal(pooled_t, maxima)


def test_pipnet_label_params_match_jax():
    """Every parameter of a PIP-Net tree gets the JAX package's label
    (mid-layer and full nets), and the bridge round-trips the tree."""
    _, params, tm = _pair()
    for mid, stages in ((True, NUM_STAGES), (False, 7)):
        ours = label_params(tm, "convnext_tiny_26", mid, stages)
        theirs = j_label_params(params, "convnext_tiny_26",
                                use_mid_layers=mid, num_stages=stages)
        for name, label in ours.items():
            assert _lookup(theirs, jax_path(name)) == label, name
    assert "intermediate" not in set(ours.values())
    back = to_jax_params(tm.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_array_equal(
            _lookup(back, tuple(k.key for k in path)), leaf)


def test_get_pipnet_factory():
    class Args:
        net = "convnext_tiny_26"
        use_mid_layers = True
        num_stages = 3
        num_features = 16

    model, p = get_pipnet(9, Args)
    assert isinstance(model, PIPNet) and p == 16
    assert model.add_on.activation == "softmax"
    assert model.classification.weight.shape == (9, 16)
    Args.num_features = 0
    assert get_pipnet(9, Args)[1] == 192
    Args.net = "resnet50"  # a ResNet: out_channels prototypes (2048)
    with torch.device("meta"):
        model, p = get_pipnet(9, Args)
    assert p == 2048 and model.classification.weight.shape == (9, 2048)


@pytest.mark.parametrize("fused", [False, True])
def test_pipnet_trajectory_matches_make_train_step(monkeypatch, fused):
    """Losses to 1e-5 relative (plain) / 1e-4 (fused); final parameters
    as in tests/test_torch_port_trajectory.py (plain: every entry within
    1 % of the largest move; fused: the difference's norm within 10 % of
    the move's norm); frozen parameters bit-unchanged."""
    jm, params, tm = _pair(fused)
    rng = np.random.default_rng(21)
    masks = [(rng.random((2 * B, 1, 1, 1)) < 1 - b.sd_prob)
             for b in tm.backbone.blocks()]
    cycle = itertools.cycle(masks[1:])  # block 0 has no stochastic depth
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(next(cycle)))
    labels_j = j_label_params(params, "convnext_tiny_26",
                              use_mid_layers=True, num_stages=NUM_STAGES)
    step_j = make_train_step(jm, labels_j, is_count_pipnet=False,
                             enforce_weight_sparsity=True,
                             tanh_loss_coeff=COEFF, donate=False)
    opt_j = adamw_init(params)
    labels = label_params(tm, "convnext_tiny_26", use_mid_layers=True,
                          num_stages=NUM_STAGES)
    opt = make_optimizer(tm, labels)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    masks_t = [torch.from_numpy(m.astype(np.float32)) for m in masks]
    data = np.random.default_rng(4)
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
            x1, x2 = (data.normal(size=(B, 64, 64, 3)).astype(np.float32)
                      for _ in range(2))
            ys = data.integers(0, NC, size=B)
            pj, _, opt_j, met = step_j(pj, {}, opt_j,
                                       (x1, x2, ys.astype(np.int32)),
                                       jax.random.PRNGKey(0), sched_j)
            losses_j.append(float(met["loss"]))
            met_t = train_step(tm, opt, (torch.from_numpy(x1),
                                         torch.from_numpy(x2),
                                         torch.from_numpy(ys)), sched,
                               is_count_pipnet=False, tanh_loss_coeff=COEFF,
                               drop_masks=masks_t)
            losses_t.append(met_t["loss"].item())
    np.testing.assert_allclose(losses_t, losses_j,
                               rtol=1e-4 if fused else 1e-5)
    for name, label in labels.items():
        if label == "frozen":
            assert torch.equal(tm.state_dict()[name], init[name]), name
    final = to_jax_params(tm.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(pj)[0]:
        names = tuple(k.key for k in path)
        leaf = np.asarray(leaf)
        diff = _lookup(final, names) - leaf
        moved = leaf - np.asarray(_lookup(params, names))
        if not moved.any():
            np.testing.assert_array_equal(diff, 0.0, err_msg=str(names))
        elif fused:
            assert np.linalg.norm(diff) <= 0.1 * np.linalg.norm(moved), names
        else:
            assert np.abs(diff).max() <= 0.01 * np.abs(moved).max(), names


def test_pipnet_evaluate_matches_jax():
    """Same parameters and batches: the info dict's statistics agree (the
    means to 1e-6), the class-prototype weights are the raw classifier
    weight, and the weight after the per-batch shrink equals JAX's."""
    jm, params, tm = _pair(seed=6)
    torch.testing.assert_close(class_prototype_weights(tm),
                               tm.classification.weight.detach())
    rng = np.random.default_rng(9)
    loader = [(rng.normal(size=(B, 64, 64, 3)).astype(np.float32),
               rng.integers(0, NC, size=B).astype(np.int32))
              for _ in range(2)]
    info_j, params_j = jeval.evaluate(jm, params, {}, loader, 1,
                                      num_classes=NC,
                                      rng=jax.random.PRNGKey(0))
    info_t = evaluate(tm, loader, 1, num_classes=NC)
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
