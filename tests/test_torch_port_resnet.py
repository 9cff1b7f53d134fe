"""The port's ResNet backbones (count_pipnet_tpu_torch/models/resnet.py)
against the JAX package's (count_pipnet_tpu/models/resnet.py), on
parameters and running statistics carried across by ``from_jax_params``:

* the forward of resnet18 and resnet50 at 64x64 in eval mode (running
  statistics) and in training mode (batch statistics), and the running
  statistics one training forward leaves, against flax's ``batch_stats``
  (the biased batch variance, momentum 0.9), with ``out_channels`` and the
  8x8 latent of the stride surgery: in float64 to 1e-9 (the same
  function), in float32 to 1e-3 of the largest value;
* a resnet18 trunk's gradients in training mode, in float64, to 1e-9;
* six steps of a resnet18 PIP-Net's ``train_step`` against
  ``make_train_step`` across the pretrain, finetune and main masks
  (resnet18's labels: the trunk frozen, its BatchNorms still moving their
  running statistics): losses to 1e-5 relative, each final parameter's
  difference norm within 1 % of its move's norm, frozen parameters
  bit-unchanged, and the running statistics of every BatchNorm equal to
  JAX's ``batch_stats`` to 1e-4 relative;
* ``label_params`` of a resnet50 PIP-Net equal to the JAX package's;
* the initialisation against flax's: conv kernels within +-2 std of
  ``variance_scaling(2, fan_out, truncated_normal)``, their std within
  10 % of the JAX tensor's; BatchNorms at one and zero, running
  statistics at zero and one;
* a torchvision resnet18 state dict and a BBN iNaturalist resnet50 one
  loaded by ``from_torch_resnet`` equal to ``convert_torch_resnet``'s
  variables.
Inputs from numpy seeds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models import resnet as jr
from count_pipnet_tpu.models.pipnet import PIPNet as JPIPNet
from count_pipnet_tpu.train.optim import adamw_init
from count_pipnet_tpu.train.optim import label_params as j_label_params
from count_pipnet_tpu.train.steps import make_train_step
from count_pipnet_tpu_torch.models import resnet as tr
from count_pipnet_tpu_torch.models.convert import (from_jax_params,
                                                   from_torch_resnet,
                                                   is_batch_stat, jax_path,
                                                   resnet_from_jax_params,
                                                   to_jax_batch_stats,
                                                   to_jax_params)
from count_pipnet_tpu_torch.models.pipnet import PIPNet, get_pipnet
from count_pipnet_tpu_torch.train.optim import (label_params, make_optimizer,
                                                set_trainable)
from count_pipnet_tpu_torch.train.steps import train_step
from test_torch_port_trajectory import PHASES, _lookup, _sched
from test_weight_convert import synth_resnet18_state_dict

NC, P, B, SIDE = 5, 8, 4, 64
NETS = {"resnet18": (jr.resnet18_features, tr.resnet18_features, 512),
        "resnet50": (jr.resnet50_features, tr.resnet50_features, 2048)}


def _x(seed, n=2):
    return np.random.default_rng(seed).normal(
        size=(n, SIDE, SIDE, 3)).astype(np.float32)


def _oihw_or_same(a):
    return np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a


def _trunk_pair(net, f64, seed=0):
    """flax and port trunks of ``net`` on the same variables (random
    running statistics, so eval mode shows them), in float64 or float32.
    Call inside ``jax.enable_x64(f64)``."""
    jf, tf, _ = NETS[net]
    dt = np.float64 if f64 else np.float32
    jb = jf(dtype=jnp.float64 if f64 else jnp.float32)
    tb = tf()
    v = jax.device_get(jb.init(jax.random.PRNGKey(seed),
                               jnp.zeros((1, SIDE, SIDE, 3), dt)))
    rng = np.random.default_rng(seed + 1)
    stats = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            v["batch_stats"])[0]:
        node = stats
        for k in path[:-1]:
            node = node.setdefault(k.key, {})
        node[path[-1].key] = (0.1 * rng.normal(size=leaf.shape)
                              if path[-1].key == "mean"
                              else 0.5 + rng.random(leaf.shape)).astype(
                                  np.float32)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, dt),
                               {"params": v["params"], "batch_stats": stats})
    sd = resnet_from_jax_params(v["params"], v["batch_stats"])
    if f64:  # the bridge gives float32; the values are float32-exact
        tb.double()
        sd = {k: t.double() for k, t in sd.items()}
    tb.load_state_dict(sd)
    return jb, v, tb


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_forward_and_batch_stats_match_flax(net, f64):
    """Eval and training forward, and the running statistics one training
    forward leaves: in float64 within 1e-9 of the largest value (the same
    function); in float32 within 1e-3 (measured 1e-5 for resnet18 and
    3e-4 for resnet50: training-mode BatchNorm over 2 images of 8x8
    amplifies the convs' float32 rounding, which the float64 run
    shows is all that differs)."""
    tol = 1e-9 if f64 else 1e-3
    with jax.enable_x64(f64):
        jb, v, tb = _trunk_pair(net, f64)
        x = _x(0).astype(np.float64 if f64 else np.float32)
        want_eval = np.asarray(jax.jit(jb.apply)(v, jnp.asarray(x)))
        want_train, upd = jax.jit(functools.partial(
            jb.apply, deterministic=False, mutable=["batch_stats"]))(
                v, jnp.asarray(x))
        want_train = np.asarray(want_train)
        upd = jax.device_get(upd["batch_stats"])
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got_eval, got_train = tb(xt).numpy(), tb(xt, train=True).numpy()
    out_ch = NETS[net][2]
    assert tb.out_channels == jb.out_channels == out_ch
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        assert got.shape == want.shape == (2, 8, 8, out_ch)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())
    sd = tb.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(upd)[0]:
        names = tuple(k.key for k in path)
        key = _torch_key(sd, ("backbone",) + names)
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(sd[key].numpy(), leaf, rtol=0,
                                   atol=tol * np.abs(leaf).max(),
                                   err_msg=str(names))


def test_training_gradients_match_flax_f64():
    """The gradients of a resnet18 trunk in training mode (batch
    statistics) under a fixed random loss, in float64, within 1e-9 of
    each tensor's norm: the backward through flax's BatchNorm. In float32
    the two differ by up to ~5e-3 relative: a training-mode BatchNorm
    removes from the cotangent its components along 1 and the normalised
    input, and what is left is small here, so the float32 rounding
    of the cotangent dominates it."""
    with jax.enable_x64(True):
        jb, v, tb = _trunk_pair("resnet18", True)
        x = _x(3).astype(np.float64)
        w = np.random.default_rng(4).normal(size=(2, 8, 8, 512))

        def loss(p):
            y, _ = jb.apply({"params": p, "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), deterministic=False,
                            mutable=["batch_stats"])
            return jnp.sum(jnp.tanh(y) * w)

        gj = jax.device_get(jax.jit(jax.grad(loss))(v["params"]))
    (torch.tanh(tb(torch.from_numpy(x), train=True))
     * torch.from_numpy(w)).sum().backward()
    n = 0
    for name, p in tb.named_parameters():
        ref = _oihw_or_same(np.asarray(_lookup(
            gj, jax_path(f"backbone.{name}")[1:])))
        got = p.grad.numpy()
        assert np.linalg.norm(got - ref) <= 1e-9 * np.linalg.norm(ref), name
        n += 1
    assert n == 20 + 2 * 20  # each conv and each BatchNorm's two


def _torch_key(sd, path):
    """The state-dict key whose jax_path is ``path`` (keys without the
    PIP-Net's ``backbone.`` prefix get it for the lookup)."""
    for key in sd:
        full = key if key.startswith("backbone.") else f"backbone.{key}"
        if jax_path(full) == path and is_batch_stat(full) == (
                path[-1] in ("mean", "var")):
            return key
    raise KeyError(path)


def _pipnet_pair(seed=5):
    """A flax and a port resnet18 PIP-Net on the same parameters and
    running statistics (the trainer's classifier init)."""
    jm = JPIPNet(num_classes=NC, num_prototypes=P,
                 backbone=jr.resnet18_features(), num_features=P)
    v = jax.device_get(jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(seed), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIDE, SIDE, 3))))
    params, stats = v["params"], v["batch_stats"]
    rng = np.random.default_rng(seed)
    params = dict(params, classification={
        "weight": (1.0 + 0.1 * rng.normal(
            size=params["classification"]["weight"].shape)).astype(
                np.float32),
        "multiplier": np.full((1,), 2.0, np.float32)})
    tm = PIPNet(num_classes=NC, num_prototypes=P,
                backbone=tr.resnet18_features(), num_features=P)
    tm.load_state_dict(from_jax_params(params, stats))
    return jm, params, stats, tm


def test_resnet18_pipnet_trajectory_matches_make_train_step():
    label_net = "resnet18"
    jm, params, stats, tm = _pipnet_pair()
    labels_j = j_label_params(params, label_net)
    step_j = make_train_step(jm, labels_j, is_count_pipnet=False,
                             enforce_weight_sparsity=True, donate=False)
    opt_j = adamw_init(params)
    labels = label_params(tm, label_net)
    opt = make_optimizer(tm, labels)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    rng = np.random.default_rng(4)
    losses_j, losses_t = [], []
    pj, mstate = params, {"batch_stats": stats}
    for phase in PHASES:
        sched, masks_on = _sched(phase)
        sched_j = {k: ({kk: jnp.float32(vv) for kk, vv in v.items()}
                       if isinstance(v, dict) else jnp.float32(v))
                   for k, v in sched.items()}
        sched_j["mask"] = {k: jnp.float32(v) for k, v in masks_on.items()}
        set_trainable(tm, labels, masks_on)
        for _ in range(2):
            x1, x2 = _x(rng.integers(1 << 30), B), _x(rng.integers(1 << 30),
                                                      B)
            ys = rng.integers(0, NC, size=B)
            pj, mstate, opt_j, met = step_j(
                pj, mstate, opt_j, (x1, x2, ys.astype(np.int32)),
                jax.random.PRNGKey(0), sched_j)
            losses_j.append(float(met["loss"]))
            met_t = train_step(tm, opt, (torch.from_numpy(x1),
                                         torch.from_numpy(x2),
                                         torch.from_numpy(ys)), sched,
                               is_count_pipnet=False)
            losses_t.append(met_t["loss"].item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    sd = tm.state_dict()
    assert {lab for n, lab in labels.items()
            if n.startswith("backbone.")} == {"frozen"}
    final = to_jax_params(sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(pj)[0]:
        names = tuple(k.key for k in path)
        leaf = np.asarray(leaf)
        diff = _lookup(final, names) - leaf
        moved = leaf - np.asarray(_lookup(params, names))
        if not moved.any():
            np.testing.assert_array_equal(diff, 0.0, err_msg=str(names))
        else:
            assert np.linalg.norm(diff) <= 0.01 * np.linalg.norm(moved), \
                names
    got_stats = to_jax_batch_stats(sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(mstate["batch_stats"]))[0]:
        names = tuple(k.key for k in path)
        leaf = np.asarray(leaf)
        assert not np.array_equal(leaf, _lookup(stats, names)), names
        np.testing.assert_allclose(_lookup(got_stats, names), leaf,
                                   rtol=1e-4, atol=1e-6, err_msg=str(names))
    for name, lab in labels.items():
        if lab == "frozen":
            assert torch.equal(sd[name], init[name]), name


def test_resnet50_labels_match_jax():
    class Args:
        net = "resnet50"
        num_features = 16

    with torch.device("meta"):
        model, _ = get_pipnet(10, Args)
    ours = label_params(model, "resnet50")
    tree = {}
    for name in ours:
        path = jax_path(name)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.zeros(1)
    theirs = j_label_params(tree, "resnet50")
    for name, label in ours.items():
        assert _lookup(theirs, jax_path(name)) == label, name
    assert ours["backbone.layer4.2.conv3.weight"] == "to_train"
    assert ours["backbone.layer3.0.downsample.1.weight"] == "to_freeze"
    assert ours["backbone.layer2.1.bn2.bias"] == "backbone"
    assert ours["backbone.layer1.0.conv1.weight"] == "frozen"
    assert {lab for n, lab in label_params(model, "resnet34").items()
            if n.startswith("backbone.")} == {"frozen"}


def test_init_matches_flax():
    jb = jr.resnet18_features()
    v = jax.device_get(jb.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, SIDE, SIDE, 3))))
    torch.manual_seed(0)
    tb = tr.resnet18_features()
    sd = tb.state_dict()
    convs = 0
    for key, t in sd.items():
        path = jax_path(f"backbone.{key}")[1:]
        coll = "batch_stats" if is_batch_stat(key) else "params"
        ref = np.asarray(_lookup(v[coll], path))
        w = t.numpy()
        assert w.size == ref.size, key
        if path[-1] == "kernel":
            out_ch, _, kh, kw = w.shape
            std = np.sqrt(2.0 / (out_ch * kh * kw)) / 0.87962566103423978
            assert np.abs(w).max() <= 2 * std * (1 + 1e-6), key
            if w.size >= 1000:
                assert abs(w.std() / ref.std() - 1) < 0.1, key
            convs += 1
        else:
            np.testing.assert_array_equal(w.reshape(ref.shape), ref,
                                          err_msg=key)
    assert convs == 20  # conv1, 16 block convs, 3 downsamples


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _check_converted(sd, params, stats):
    """The port's module loads ``sd`` strictly and carries it back to the
    JAX converter's (params, batch_stats)."""
    got_p = _flat(to_jax_params({f"backbone.{k}": v for k, v in sd.items()})
                  ["backbone"])
    got_s = _flat(to_jax_batch_stats(
        {f"backbone.{k}": v for k, v in sd.items()})["backbone"])
    want_p, want_s = _flat(jax.device_get(params)), _flat(
        jax.device_get(stats))
    assert got_p.keys() == want_p.keys() and got_s.keys() == want_s.keys()
    for k in want_p:
        np.testing.assert_array_equal(got_p[k], want_p[k], err_msg=str(k))
    for k in want_s:
        np.testing.assert_array_equal(got_s[k], want_s[k], err_msg=str(k))


def test_torchvision_state_dict_loads_like_convert_torch_resnet():
    raw = synth_resnet18_state_dict(np.random.default_rng(3))
    raw["bn1.num_batches_tracked"] = np.int64(7)
    sd = from_torch_resnet({k: torch.as_tensor(v) for k, v in raw.items()})
    assert not any(k.startswith("fc.") or "num_batches" in k for k in sd)
    tr.resnet18_features().load_state_dict(sd)
    params, stats = jr.convert_torch_resnet(
        {k: v for k, v in raw.items() if "num_batches" not in k},
        (2, 2, 2, 2), bottleneck=False)
    _check_converted(sd, params, stats)


def test_bbn_inat_state_dict_loads_like_convert_torch_resnet():
    """A BBN checkpoint: ``module.backbone.`` keys with ``cb_block`` for
    layer4.2 and an ``rb_block`` beside it, and a ``module.classifier``."""
    torch.manual_seed(4)
    base = tr.resnet50_features().state_dict()
    rng = np.random.default_rng(4)
    raw = {}
    for k, v in base.items():
        v = torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(
            np.float32)).abs() + 0.5
        if k.startswith("layer4.2."):
            raw["module.backbone." + k.replace("layer4.2", "cb_block")] = v
            raw["module.backbone." + k.replace("layer4.2", "rb_block")] = -v
        else:
            raw["module.backbone." + k] = v
    raw["module.classifier.weight"] = torch.ones(3, 2048)
    sd = from_torch_resnet(raw, inat=True)
    model = tr.resnet50_features_inat()
    model.load_state_dict(sd)
    assert torch.equal(model.layer4[2].conv1.weight,
                       raw["module.backbone.cb_block.conv1.weight"])
    params, stats = jr.convert_torch_resnet(raw, (3, 4, 6, 3),
                                            bottleneck=True, inat=True)
    _check_converted(sd, params, stats)
