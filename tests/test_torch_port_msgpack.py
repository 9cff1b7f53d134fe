"""Reading the JAX package's checkpoints without msgpack, flax or JAX:

* utils/msgpack.py's ``unpackb`` against ``flax.serialization.
  msgpack_restore`` on random trees (f32, bf16, int32 and bool arrays,
  numpy scalars, empty dicts, lists, str, ints of every width, floats,
  nil, bools), on flax's chunked form of oversized arrays (under a
  small ``MAX_CHUNK_SIZE``), and its refusals by name (the complex ext,
  an unknown ext, an undefined format byte, a non-str map key);
* files written by the JAX package's own ``CheckpointManager`` loaded
  through each route of train/trainer.py:restore_initial_state:
  ``--state_dict_dir_net``, the hash-matched discovery in
  ``--pretrained_checkpoints_dir``, ``--shared_pretrained_dir`` (backbone
  and add-on only) and ``--resume_training`` (a resnet18 PIP-Net with its
  running statistics and AdamW state). The port's forward then equals
  the JAX forward on the same file (to 1e-5 of the largest output), and
  one step after the resume equals the JAX step after its resume: loss to
  1e-5 relative, each parameter within 1e-3 of its largest move, each
  running statistic within 1e-5 of its tensor's largest value.
Small widths; inputs from numpy seeds."""

import flax.serialization as fs
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from count_pipnet_tpu.config import build_parser as j_build_parser
from count_pipnet_tpu.models.pipnet import get_count_network as j_count_net
from count_pipnet_tpu.models.pipnet import get_pipnet as j_pipnet
from count_pipnet_tpu.train.optim import adamw_init
from count_pipnet_tpu.train.optim import label_params as j_label_params
from count_pipnet_tpu.train.steps import make_train_step
from count_pipnet_tpu.utils import checkpoint as jck
from count_pipnet_tpu_torch.config import build_parser
from count_pipnet_tpu_torch.models.convert import (to_jax_batch_stats,
                                                   to_jax_params)
from count_pipnet_tpu_torch.train.optim import masks_of, set_trainable
from count_pipnet_tpu_torch.train.steps import train_step
from count_pipnet_tpu_torch.train.trainer import (Trainer,
                                                  restore_initial_state)
from count_pipnet_tpu_torch.utils.checkpoint import CheckpointManager
from count_pipnet_tpu_torch.utils.msgpack import unpackb
from test_torch_port_trajectory import LR, _lookup

NC, SIDE = 4, 32


def _random_tree(rng, depth=0):
    tree = {
        "f32": rng.normal(size=tuple(rng.integers(1, 5, rng.integers(0, 4))))
        .astype(np.float32),
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(3, 5)),
                                       jnp.bfloat16)),
        "i32": rng.integers(-2**31, 2**31 - 1, (4, 2)).astype(np.int32),
        "flags": rng.random(6) < 0.5,
        "scalar_f32": np.float32(rng.normal()),
        "scalar_i32": np.int32(rng.integers(-1000, 1000)),
        "empty": {},
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                 2**63 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                 -2**31, -2**31 - 1, -2**63],
        "floats": [0.5, -1e300, float(np.float32(3.25))],
        "text": "x" * int(rng.integers(0, 300)),
        "nil": None, "yes": True, "no": False,
    }
    if depth < 2:
        tree["child"] = _random_tree(rng, depth + 1)
    return tree


def _assert_same(got, want, path=()):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], path + (k,))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert torch.is_tensor(got), path
        assert tuple(got.shape) == np.shape(want), path
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
        else:
            assert got.numpy().dtype == want.dtype, path
            np.testing.assert_array_equal(got.numpy(), want)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, path + (i,))
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("seed", range(3))
def test_decoder_matches_msgpack_restore(seed):
    blob = fs.msgpack_serialize(_random_tree(np.random.default_rng(seed)))
    _assert_same(unpackb(blob), fs.msgpack_restore(blob))


def test_decoder_joins_chunked_arrays(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes are written as chunk maps; a small
    limit makes these arrays take 2 to 30 chunks."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 40)
    rng = np.random.default_rng(7)
    tree = {"big": rng.normal(size=(6, 50)).astype(np.float32),
            "bf16": np.asarray(jnp.asarray(rng.normal(size=(33,)),
                                           jnp.bfloat16)),
            "nested": {"i32": np.arange(23, dtype=np.int32)},
            "small": np.ones(3, np.float32)}
    blob = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    _assert_same(unpackb(blob), fs.msgpack_restore(blob))


@pytest.mark.parametrize("blob,match", [
    (fs.msgpack_serialize({"c": 1 + 2j}), r"ext type 2 \(native_complex\)"),
    (msgpack.packb(msgpack.ExtType(9, b"ab")), r"ext type 9"),
    (b"\xc1", "format byte 0xc1"),
    (msgpack.packb({1: 2}), "map key 1"),
    (msgpack.packb([1, 2]) + b"\x00", "past the end"),
], ids=["complex", "ext9", "undefined_byte", "int_key", "trailing"])
def test_decoder_refuses_by_name(blob, match):
    with pytest.raises(ValueError, match=match):
        unpackb(blob)


def _args(parser, log_dir, *extra):
    return parser().parse_args([
        "--model", "count_pipnet", "--dataset", "geometric_shapes",
        "--net", "convnext_tiny_26", "--use_mid_layers", "--num_stages", "1",
        "--num_features", "8", "--max_count", "3", "--activation", "softmax",
        "--image_size", str(SIDE), "--dtype", "float32", "--disable_cuda",
        "--seed", "3", "--log_dir", str(log_dir), *extra])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run directory holding net_pretrained (+ its hash copy) of a
    small softmax Count-PIPNet, written by the JAX CheckpointManager."""
    root = tmp_path_factory.mktemp("jax_run")
    args = _args(j_build_parser, root / "run")
    model, _ = j_count_net(NC, args, max_count=3, use_ste=False)
    params = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(11), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIDE, SIDE, 3)))["params"])
    # layer scales 0.2, so every block shows in the forward
    params["backbone"] = {k: (dict(v, layer_scale=np.full_like(
        v["layer_scale"], 0.2)) if "layer_scale" in v else v)
        for k, v in params["backbone"].items()}
    jck.CheckpointManager(args).save_pretrained_checkpoint(params, {})
    return root / "run", model, params


def _forwards(model, params, trainer, seed=0):
    x = np.random.default_rng(seed).normal(
        size=(2, SIDE, SIDE, 3)).astype(np.float32)
    proto_j, _, out_j = model.apply({"params": params}, jnp.asarray(x),
                                    inference=True,
                                    rngs={"gumbel": jax.random.PRNGKey(0)})
    with torch.no_grad():
        proto_t, _, out_t = trainer.model(torch.from_numpy(x),
                                          inference=True)
    return ((np.asarray(proto_j), proto_t.numpy()),
            (np.asarray(out_j), out_t.numpy()))


def _close(pair):
    want, got = pair
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("route", ["state_dict_dir_net", "discovery",
                                   "shared_pretrained_dir"])
def test_jax_pretrained_checkpoint_routes(jax_run, tmp_path, route, capsys):
    """Each route of a fresh run reads the JAX file; the port's forward
    equals the JAX forward on the parameters the JAX loader gives (the
    shared route takes the backbone and add-on only: the prototype
    maps)."""
    run, model, params = jax_run
    flag = {"state_dict_dir_net": ["--state_dict_dir_net",
                                   str(run / "checkpoints" /
                                       "net_pretrained")],
            "discovery": ["--pretrained_checkpoints_dir", str(run)],
            "shared_pretrained_dir": ["--shared_pretrained_dir",
                                      str(run)]}[route]
    args = _args(build_parser, tmp_path / "port", *flag)
    trainer = Trainer(args, NC)
    assert restore_initial_state(trainer, CheckpointManager(args),
                                 args) == (1, False)
    assert args.epochs_pretrain == 0
    out = capsys.readouterr().out
    jargs = _args(j_build_parser, tmp_path / "jax", *flag)
    target = {"params": params, "batch_stats": {}, "opt_state": {}}
    if route == "shared_pretrained_dir":
        assert "Successfully loaded shared pretrained backbone" in out
        loaded, info = jck.load_backbone_only(
            jck.find_shared_backbone(str(run)), params)
        assert info["success"]
        proto, _ = _forwards(model, loaded, trainer)
        _close(proto)
        got = to_jax_params(trainer.model.state_dict())
        assert not np.array_equal(got["classification"]["weight"],
                                  params["classification"]["weight"])
        return
    assert "Loaded pretrained checkpoint from standard location" in out
    state, _ = jck.CheckpointManager(jargs).load_pretrained_checkpoint(
        target)
    for pair in _forwards(model, state["params"], trainer):
        _close(pair)


def _resnet_args(parser, log_dir, *extra):
    return parser().parse_args([
        "--dataset", "geometric_shapes", "--net", "resnet18",
        "--num_features", "8", "--image_size", str(SIDE),
        "--dtype", "float32", "--disable_cuda", "--seed", "3",
        "--log_dir", str(log_dir), *extra])


def _batch(rng, n=4):
    xs = [rng.normal(size=(n, SIDE, SIDE, 3)).astype(np.float32)
          for _ in range(2)]
    return xs[0], xs[1], rng.integers(0, NC, size=n)


def test_jax_resume_then_step_matches_jax(tmp_path, capsys):
    """A resnet18 PIP-Net trained two JAX steps and saved by the JAX
    CheckpointManager (params, batch_stats, AdamW mu / nu / step, epoch,
    tau) resumes in the port: forward equal, then one more step on both
    sides equal."""
    args_j = _resnet_args(j_build_parser, tmp_path / "run")
    model, _ = j_pipnet(NC, args_j)
    v = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(2), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIDE, SIDE, 3))))
    params, stats = v["params"], v["batch_stats"]
    labels = j_label_params(params, "resnet18")
    step = make_train_step(model, labels, is_count_pipnet=False,
                           donate=False)
    sched = {"lr": {k: jnp.float32(x) for k, x in LR.items()},
             "mask": {k: jnp.float32(1.0) for k in LR},
             "align_w": jnp.float32(5.0), "tanh_w": jnp.float32(2.0),
             "class_w": jnp.float32(2.0), "pretrain": jnp.float32(0.0),
             "finetune": jnp.float32(0.0), "tau": jnp.float32(1.0),
             "project": jnp.float32(1.0)}
    rng = np.random.default_rng(5)
    opt = adamw_init(params)
    mstate = {"batch_stats": stats}
    for _ in range(2):
        x1, x2, ys = _batch(rng)
        params, mstate, opt, _ = step(params, mstate, opt,
                                      (x1, x2, ys.astype(np.int32)),
                                      jax.random.PRNGKey(0), sched)
    jck.CheckpointManager(args_j).save_trained_checkpoint(
        jax.device_get(params), jax.device_get(mstate["batch_stats"]),
        jax.device_get(opt), 1, tau=0.7)

    args_j = _resnet_args(j_build_parser, tmp_path / "run",
                          "--resume_training")
    target = {"params": params, "batch_stats": mstate["batch_stats"],
              "opt_state": opt}
    state, meta = jck.CheckpointManager(args_j).load_trained_checkpoint(
        target)
    args = _resnet_args(build_parser, tmp_path / "run", "--resume_training")
    trainer = Trainer(args, NC)
    assert restore_initial_state(trainer, CheckpointManager(args),
                                 args) == (2, True)
    assert trainer.tau == pytest.approx(0.7)
    assert "Resuming training from epoch 2" in capsys.readouterr().out
    variables = {"params": state["params"],
                 "batch_stats": state["batch_stats"]}
    x = rng.normal(size=(2, SIDE, SIDE, 3)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x),
                                  inference=True)[2])
    with torch.no_grad():
        got = trainer.model(torch.from_numpy(x), inference=True)[2].numpy()
    _close((want, got))
    steps = {n: int(st["step"]) for n, st in
             ((n, trainer.optimizer.state[p]) for n, p in
              trainer.model.named_parameters()
              if p in trainer.optimizer.state)}
    assert steps and set(steps.values()) == {2}
    assert all(n.startswith(("add_on.", "classification.weight"))
               for n in steps), sorted(steps)

    x1, x2, ys = _batch(rng)
    p_j, m_j, _, met = step(state["params"],
                            {"batch_stats": state["batch_stats"]},
                            state["opt_state"],
                            (x1, x2, ys.astype(np.int32)),
                            jax.random.PRNGKey(0), sched)
    before = to_jax_params(trainer.model.state_dict())
    set_trainable(trainer.model, trainer.labels, masks_of(set(LR)))
    sched_t = {k: (dict(LR) if k == "lr" else float(x))
               for k, x in sched.items() if k != "mask"}
    met_t = train_step(trainer.model, trainer.optimizer,
                       (torch.from_numpy(x1), torch.from_numpy(x2),
                        torch.from_numpy(ys)), sched_t,
                       is_count_pipnet=False)
    np.testing.assert_allclose(met_t["loss"].item(), float(met["loss"]),
                               rtol=1e-5)
    sd = trainer.model.state_dict()
    final = to_jax_params(sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(p_j))[0]:
        names = tuple(k.key for k in path)
        leaf = np.asarray(leaf)
        moved = np.abs(leaf - _lookup(before, names)).max()
        assert np.abs(_lookup(final, names) - leaf).max() <= max(
            1e-3 * moved, 1e-7), names
    got_stats = to_jax_batch_stats(sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(m_j["batch_stats"]))[0]:
        names = tuple(k.key for k in path)
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(_lookup(got_stats, names), leaf, rtol=0,
                                   atol=1e-5 * np.abs(leaf).max(),
                                   err_msg=str(names))
