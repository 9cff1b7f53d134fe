"""Data-parallel training of the port (count_pipnet_tpu_torch/parallel/)
on the CPU: a world of 2 gloo ranks, spawned once for the file.

* The loader's rank slices equal the JAX package's ``DataLoader`` with the
  same ``process_index`` / ``process_count`` (the same index slices, the
  same items; the divisibility and ragged errors), ``host_batch_slice``
  and ``make_mesh``'s error likewise.
* A 2-rank step equals JAX's 2-device sharded step
  (tests/test_multichip.py's pattern: softmax activation, tanh and class
  terms on; the weights carried over by models/convert.py), in a
  pretraining and a joint phase, with and without class weights: loss
  rtol 1e-4, classifier weights rtol 1e-4 / atol 1e-5.
* A 2-rank step equals the port's one-process step on the joined batch
  in every case of tests/torch_parallel_worker.py: those four, Gumbel
  activation with drawn noise and stochastic depth, the device
  augmentation with ``--device_geometric``, and a ResNet-18 PIP-Net whose
  BatchNorm reads the world's statistics (its trunk's gradients in
  float64). The two ranks end bit-equal.
* ``python -m count_pipnet_tpu_torch.main --mesh_shape 2 --disable_cuda``
  writes one artifact tree, from rank 0 alone, whose CSV equals the
  one-process run's; without CUDA and without ``--disable_cuda`` it exits
  2.
"""

import csv
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from count_pipnet_tpu.data.loader import DataLoader as JDataLoader
from count_pipnet_tpu_torch.data.loader import DataLoader
from count_pipnet_tpu_torch.models.convert import (from_jax_params,
                                                   to_jax_params)
from count_pipnet_tpu_torch.parallel.distributed import host_batch_slice
from count_pipnet_tpu_torch.parallel.mesh import make_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]


class _Items:
    """A dataset whose item is a function of (index, item rng)."""

    def __len__(self):
        return 22

    def __getitem__(self, key):
        index, rng = key
        return (np.full((2, 3), index + rng.random(), np.float32), index)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, drop_last=True),
    dict(batch_size=6, shuffle=False, drop_last=True,
         sample_weights=np.linspace(1.0, 2.0, 22)),
], ids=["shuffled", "weighted"])
def test_loader_rank_slices_match_jax(kw):
    """Each rank's batches (indices and items) equal the JAX loader's for
    the same rank, and the ranks' slices join to the one-process batch."""
    ours = [DataLoader(_Items(), seed=5, num_workers=2, process_index=r,
                       process_count=2, **kw) for r in range(2)]
    theirs = [JDataLoader(_Items(), seed=5, num_workers=2, process_index=r,
                          process_count=2, **kw) for r in range(2)]
    whole = DataLoader(_Items(), seed=5, num_workers=2, **kw)
    for ld in ours + theirs + [whole]:
        ld.set_epoch(3)
    got = [list(ld) for ld in ours]
    for a, b in zip(got, (list(ld) for ld in theirs)):
        assert len(a) == len(b) == len(whole)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])
    for x0, x1, xw in zip(*got, whole):
        np.testing.assert_array_equal(np.concatenate([x0[0], x1[0]]), xw[0])


class _Ragged(_Items):
    def __len__(self):
        return 7


def test_loader_and_slice_errors_match_jax():
    from count_pipnet_tpu.parallel.distributed import \
        host_batch_slice as j_slice
    for loader in (DataLoader, JDataLoader):
        with pytest.raises(ValueError, match="batch_size 5 not divisible "
                           "by 2 processes"):
            loader(_Items(), 5, process_count=2)
        with pytest.raises(ValueError, match="ragged batch of 3 not "
                           "divisible by 2 processes"):
            list(loader(_Ragged(), 4, drop_last=False, process_count=2))
    for args in ((8, 1, 2), (12, 2, 3), (6, 0, 1)):
        assert host_batch_slice(*args) == j_slice(*args)
    with pytest.raises(ValueError, match="global batch 7 not divisible "
                       "by 2 processes"):
        host_batch_slice(7, 0, 2)


def test_make_mesh_one_process():
    """Outside a world: one device; a larger mesh than the devices raises
    the JAX package's error."""
    mesh = make_mesh(-1, "cpu")
    assert (mesh.size, mesh.rank, mesh.distributed) == (1, 0, False)
    with pytest.raises(ValueError, match="requested mesh of 2 devices but "
                       "only 1 available"):
        make_mesh(2, "cpu")


# -- the world --------------------------------------------------------------

_JAX_STEPS = {}


@pytest.fixture(scope="module")
def jax_params():
    """The JAX model of the JAX cases and its initial parameters."""
    import jax
    import jax.numpy as jnp
    from count_pipnet_tpu.models import get_count_network

    class Args:
        net = "convnext_tiny_26"
        num_features = 4
        use_mid_layers = True
        num_stages = 2
        bias = False
        activation = "softmax"
        intermediate_layer = "onehot"
        positive_grad_strategy = None
        backward_clamp_strategy = "Identity"
        disable_pretrained = True

    model, _ = get_count_network(W.NC, Args, max_count=3, use_ste=True)
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, W.IMG, W.IMG, 3)))["params"]
    return model, jax.device_get(params)


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_params):
    """Every case's step on a world of 2 spawned gloo ranks, started once
    for the file (``.results()``: each rank's results; the JAX steps are
    computed while the ranks run)."""
    weights = {c: from_jax_params(jax_params[1]) for c in W.JAX_CASES}
    return W.World(tmp_path_factory.mktemp("world"), weights)


def _jax_sharded_step(case, jax_params, monkeypatch):
    """JAX's train step on a 2-device mesh over the case's global batch,
    every stochastic-depth mask kept."""
    import jax
    import jax.numpy as jnp
    from count_pipnet_tpu.parallel.mesh import (make_mesh as j_mesh,
                                                replicate, shard_batch)
    from count_pipnet_tpu.train.optim import adamw_init, label_params
    from count_pipnet_tpu.train.steps import make_train_step
    model, params = jax_params
    _, phase, weighted, _ = W.CASES[case]
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.ones(shape, bool))
    if weighted not in _JAX_STEPS:
        labels = label_params(params, "convnext_tiny_26",
                              use_mid_layers=True, num_stages=2)
        _JAX_STEPS[weighted] = make_train_step(
            model, labels, is_count_pipnet=True, tanh_loss_coeff=0.1,
            weight_decay=0.0, donate=False,
            class_weights=np.asarray(W.CLASS_WEIGHTS, np.float32)
            if weighted else None)
    sched = W.sched_of(case)
    trainable = W.PHASES[phase][0]
    sched = dict({k: jnp.float32(v) for k, v in sched.items()
                  if k != "lr"},
                 lr={k: jnp.float32(v) for k, v in sched["lr"].items()},
                 mask={k: jnp.float32(k in trainable) for k in W.LABELS})
    xs1, xs2, ys = W.batch_of(case)
    mesh = j_mesh(2)
    p, _, _, m = _JAX_STEPS[weighted](
        replicate(mesh, params), {}, replicate(mesh, adamw_init(params)),
        shard_batch(mesh, (xs1, xs2, ys.astype(np.int32))),
        jax.random.PRNGKey(4), sched)
    return float(m["loss"]), np.asarray(p["classification"]["weight"])


@pytest.mark.parametrize("case", W.JAX_CASES)
def test_world_step_matches_jax_sharded_step(case, jax_params, world,
                                             monkeypatch):
    loss_j, w_j = _jax_sharded_step(case, jax_params, monkeypatch)
    got = world.results()[0][case]
    np.testing.assert_allclose(got["metrics"]["loss"], loss_j, rtol=1e-4)
    w = to_jax_params(got["state"])["classification"]["weight"]
    np.testing.assert_allclose(w, w_j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", list(W.CASES))
def test_world_step_equals_one_process_step(case, jax_params, world):
    """The world's step against the one-process step on the joined batch
    (the same seed, so the same draws): the world's metrics within 1e-5
    relative; the summed gradients, and the buffers (BatchNorm's running
    statistics), within 1e-5 of each tensor's largest value (the float64
    trunk's gradients within 1e-9, test_torch_port_resnet.py's
    tolerance); every
    parameter within 1 % of how far its tensor moved in the step (the
    trajectory tests' eager rule) or 1e-6, except where its gradient is
    under 1e-4 of the tensor's largest: AdamW's first update is lr g /
    (|g| + eps), so a gradient that rounding leaves near zero moves by
    +-lr either way; the two ranks bit-equal."""
    weights = (from_jax_params(jax_params[1]) if case in W.JAX_CASES
               else None)
    ref = W.local_step(case, weights)
    init = ref["init"]
    r0, r1 = (world.results()[r][case] for r in range(2))
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert r0["grads"].keys() == ref["grads"].keys()
    tol = 1e-9 if case.endswith("f64") else 1e-5
    for k, g in ref["grads"].items():
        err = (r0["grads"][k] - g).abs().max().item()
        assert err <= tol * g.abs().max().item() + 1e-12, (k, err)
    for k, v in ref["state"].items():
        if not v.is_floating_point():
            assert torch.equal(r0["state"][k], v), k
            continue
        got, g = r0["state"][k], ref["grads"].get(k)
        if g is None:   # a buffer, or a parameter that did not train
            err = (got - v).abs().max().item()
            assert err <= 1e-5 * v.abs().max().item() + 1e-7, (k, err)
            continue
        keep = g.abs() >= 1e-4 * g.abs().max()
        moved = (v - init[k]).abs().max().item()
        err = (got - v)[keep].abs().max().item()
        assert err <= max(1e-2 * moved, 1e-6), (k, err, moved)


# -- the CLI ----------------------------------------------------------------

RECIPE = [
    "--dataset", "geometric_shapes", "--model", "count_pipnet",
    "--image_size", "32", "--net", "convnext_tiny_26", "--use_mid_layers",
    "--num_stages", "2", "--num_features", "4", "--max_count", "3",
    "--use_ste", "True", "--intermediate_layer", "onehot",
    "--batch_size", "8", "--batch_size_pretrain", "8", "--epochs", "2",
    "--epochs_pretrain", "1", "--epochs_finetune", "1", "--freeze_epochs",
    "0", "--lr", "0.01", "--lr_block", "0.001", "--lr_net", "0.001",
    "--num_workers", "2", "--seed", "1", "--dtype", "float32",
    "--tanh_loss_coeff", "0.1", "--disable_pretrained",
    "--viz_prototype_maps", "False"]


def _files(run):
    return sorted(p.relative_to(run).as_posix() for p in run.rglob("*")
                  if p.is_file())


def test_cli_mesh_shape_2_equals_one_process(tmp_path, monkeypatch):
    """Two gloo ranks on the CPU (a subprocess) write the one-process run's
    (this process, meanwhile) artifact tree, from rank 0 alone (no file a
    rank 1 copy would add), and their CSV equals the one-process run's
    within 1e-4."""
    from count_pipnet_tpu_torch.data.generate_shapes import main as gen
    from count_pipnet_tpu_torch.main import main
    gen(["--output_dir", str(tmp_path / "data/geometric_shapes/dataset"),
         "--img_size", "32", "--train_samples_per_class", "4",
         "--test_samples_per_class", "2", "--seed", "0"])
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    world = subprocess.Popen(
        [sys.executable, "-m", "count_pipnet_tpu_torch.main", *RECIPE,
         "--disable_cuda", "--mesh_shape", "2", "--log_dir", "./runs/m2"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    monkeypatch.chdir(tmp_path)
    try:
        assert main(RECIPE + ["--disable_cuda", "--log_dir",
                              "./runs/m1"]) == 0
    finally:
        out, err = world.communicate(timeout=300)
    assert world.returncode == 0, out[-3000:] + err[-3000:]
    runs = {n: tmp_path / "runs" / f"m{n}" for n in (1, 2)}
    assert _files(runs[2]) == _files(runs[1])
    log = (runs[2] / "out.txt").read_text()
    assert "Done!" in log and "Traceback" not in log
    rows = {}
    for n, run in runs.items():
        with open(run / "log_epoch_overview.csv") as f:
            rows[n] = list(csv.reader(f))
    assert len(rows[2]) == len(rows[1]) == 4
    for a, b in zip(rows[2][1:], rows[1][1:]):
        for x, y in zip(a, b):
            if y == "n.a.":
                assert x == y
            else:
                np.testing.assert_allclose(float(x), float(y), rtol=1e-4,
                                           atol=1e-6)


def test_cli_mesh_shape_2_needs_cuda_or_disable_cuda(capsys):
    from count_pipnet_tpu_torch.main import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert main(RECIPE + ["--mesh_shape", "2", "--log_dir", "unused"]) == 2
    assert "--disable_cuda" in capsys.readouterr().err
