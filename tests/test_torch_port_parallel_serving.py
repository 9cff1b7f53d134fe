"""Data-parallel serving of the port on the CPU, its native batch
assembler, its kernel launch guard and its dry run.

* ``models.serving.shard_serving_fn`` over ``["cpu", "cpu"]`` equals the
  unsharded call on the softmax route (and JAX's ``shard_serving_fn`` on a
  2-device mesh), and on the gumbel routes (kernel C int8-static and
  dynamic, kernel B behind an add-on) with injected noise: counts equal,
  logits within 1e-5. With drawn noise it is held statistically: the
  counts of an image sum to its patch count, a seed repeats, another seed
  differs, and the two shards of a call draw apart.
* ``ServingEngine(..., devices=)`` rejects a ladder size the devices do not
  divide, pads partial batches and returns each request's unsharded
  result (tests/test_multichip_serving.py's pattern).
* ``native.stack_batch`` / ``normalize_batch`` equal numpy and the JAX
  package's native assembler.
* ``ops.cuda.check_current_device``: a launch whose tensor is not on the
  current CUDA device raises.
* ``python -m count_pipnet_tpu_torch.dryrun 2`` prints its OK line (run
  in the background while the rest of the file runs).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.pipnet import CountPIPNet
from count_pipnet_tpu_torch.models.quantized import calibrate_act_scales
from count_pipnet_tpu_torch.models.serving import (make_gumbel_serving_fn,
                                                   make_serving_fn,
                                                   shard_serving_fn,
                                                   with_seed_counter)
from count_pipnet_tpu_torch.serving import ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPUS = ["cpu", "cpu"]
STAGES = ((32, 1), (64, 1))


@pytest.fixture(scope="module", autouse=True)
def dryrun():
    """The dry run in a subprocess, started before the file's first test."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "count_pipnet_tpu_torch.dryrun", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc
    proc.kill()
    proc.communicate()


def _softmax_pair(batch=4):
    """The JAX model, its parameters (layer scales 0.1), the port's model on
    them and ``batch`` images (tests/test_torch_port_serving_softmax.py's
    two-stage model)."""
    import jax
    import jax.numpy as jnp
    from count_pipnet_tpu.models import get_count_network as jax_network
    from count_pipnet_tpu_torch.models.convert import from_jax_params
    from count_pipnet_tpu_torch.models.pipnet import get_count_network

    class Args:
        net = "convnext_tiny_26"
        num_features = 64
        use_mid_layers = True
        num_stages = 2
        bias = False
        activation = "softmax"
        intermediate_layer = "onehot"
        positive_grad_strategy = None
        backward_clamp_strategy = "Identity"
        disable_pretrained = True

    jm, _ = jax_network(3, Args, max_count=3, use_ste=True)
    x = np.random.default_rng(1).uniform(size=(batch, 32, 32, 3)) \
        .astype(np.float32)
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(1)},
                                    jnp.asarray(x[:1]))["params"])
    for scope, sub in params["backbone"].items():
        if "_block_" in scope:
            sub["layer_scale"] = np.full_like(sub["layer_scale"], 0.1)
    tm, _ = get_count_network(3, Args, max_count=3)
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm.eval(), x


@pytest.fixture(scope="module")
def softmax():
    return _softmax_pair()


def test_sharded_softmax_equals_unsharded_and_jax(softmax):
    """Counts equal, logits within 1e-5, against the unsharded call and
    against JAX's shard_serving_fn (XLA head) on a 2-device mesh."""
    import jax
    from count_pipnet_tpu.models.serving import make_serving_fn as j_fn
    from count_pipnet_tpu.models.serving import \
        shard_serving_fn as j_shard
    from count_pipnet_tpu.parallel.mesh import make_mesh as j_mesh
    jm, params, tm, x = softmax
    counts, logits = shard_serving_fn(make_serving_fn, tm, CPUS)(x)
    c1, l1 = make_serving_fn(tm, device="cpu")(x)
    infer_j, _ = j_shard(j_fn(jm, use_pallas=False), j_mesh(2), params)
    cj, lj = (np.asarray(t) for t in jax.device_get(infer_j(x)))
    assert counts.shape == (4, 64) and len(np.unique(cj)) > 1
    for c, lg in ((c1.numpy(), l1.numpy()), (cj, lj)):
        np.testing.assert_array_equal(counts.numpy(), c)
        np.testing.assert_allclose(logits.numpy(), lg, rtol=1e-5,
                                   atol=1e-5)


def _gumbel(num_features, max_count=3, seed=0):
    torch.manual_seed(seed)
    return CountPIPNet(num_classes=6, num_prototypes=num_features or 64,
                       backbone=ConvNeXtFeatures(STAGES, 40, num_stages=3),
                       max_count=max_count, num_features=num_features)


def _images(n, seed=4):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)) \
        .astype(np.float32)


GUMBEL_ROUTES = {
    # kernel C (num_features 0: the last block fused with the head)
    "int8_static": (0, True, 64),
    "int8_dynamic": (0, False, 64),
    # kernel B behind the add-on 1x1 conv
    "add_on": (16, True, 64),
}


@pytest.mark.parametrize("route", list(GUMBEL_ROUTES))
def test_sharded_gumbel_with_injected_noise_equals_unsharded(route):
    num_features, static, int8_min_dim = GUMBEL_ROUTES[route]
    model = _gumbel(num_features)
    x = _images(4)
    scales = (calibrate_act_scales(model.backbone, torch.from_numpy(x))
              if static else None)
    kw = dict(act_scales=scales, dtype=torch.float32,
              int8_min_dim=int8_min_dim)
    with torch.no_grad():
        h, w = model.backbone(torch.from_numpy(x)).shape[1:3]
    noise = torch.from_numpy(np.random.default_rng(9).gumbel(
        size=(4, h, w, model.num_prototypes)).astype(np.float32))
    counts, logits = shard_serving_fn(make_gumbel_serving_fn, model, CPUS,
                                      **kw)(x, 3, noise)
    c1, l1 = make_gumbel_serving_fn(model, device="cpu", **kw)(x, 3, noise)
    assert counts.shape == (4, model.num_prototypes)
    assert len(torch.unique(c1)) > 1
    assert torch.equal(counts, c1)
    np.testing.assert_allclose(logits.numpy(), l1.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sharded_gumbel_drawn_noise():
    """max_count 16 = the patch count, so no count is clamped: each image's
    counts sum to its patches; the same seed repeats, another differs; the
    same images in the two shards of a call draw different counts."""
    model = _gumbel(0, max_count=16)
    x = _images(2)
    x = np.concatenate([x, x])            # shard 1 repeats shard 0
    infer = shard_serving_fn(make_gumbel_serving_fn, model, CPUS,
                             dtype=torch.float32, int8_min_dim=64)
    with torch.no_grad():
        h, w = model.backbone(torch.from_numpy(x)).shape[1:3]
    assert h * w == 16
    a, _ = infer(x, 5)
    b, _ = infer(x, 5)
    c, _ = infer(x, 6)
    assert torch.equal(a.sum(dim=1), torch.full((4,), 16.0))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[:2], a[2:])


def test_engine_devices_ladder_padding_and_results(softmax):
    """Every ladder size must divide by the devices; 3 requests pad to the
    4-slot ladder; each request gets its row of the unsharded forward; the
    gumbel route through with_seed_counter answers too."""
    _, _, tm, x = softmax
    with pytest.raises(ValueError, match="not divisible"):
        ServingEngine(lambda b: b, (32, 32, 3), batch_sizes=(4, 6),
                      devices=["cpu"] * 4)
    infer = shard_serving_fn(make_serving_fn, tm, CPUS)
    c1, l1 = make_serving_fn(tm, device="cpu")(x)
    with ServingEngine(infer, (32, 32, 3), batch_sizes=(4,),
                       max_wait_ms=250.0, devices=CPUS) as eng:
        results = [f.result(timeout=60) for f in eng.submit_many(x[:3])]
        stats = eng.stats()
    assert stats["padded_slots"] == 1
    for i, (c, lg) in enumerate(results):
        np.testing.assert_array_equal(c, c1[i].numpy())
        np.testing.assert_allclose(lg, l1[i].numpy(), rtol=1e-5, atol=1e-5)
    gumbel = shard_serving_fn(make_gumbel_serving_fn, _gumbel(0), CPUS,
                              dtype=torch.float32, int8_min_dim=64)
    imgs = _images(4)
    with ServingEngine(with_seed_counter(gumbel), (32, 32, 3),
                       batch_sizes=(2, 4), max_wait_ms=250.0,
                       devices=CPUS) as eng:
        got = [f.result(timeout=60) for f in eng.submit_many(imgs)]
    want, _ = gumbel(imgs, 1)
    assert np.array_equal(np.stack([c for c, _ in got]), want.numpy())


def test_native_assembler_equals_numpy_and_jax():
    from count_pipnet_tpu import native as jnative
    from count_pipnet_tpu_torch import native
    rng = np.random.default_rng(2)
    imgs = [rng.normal(size=(6, 5, 3)).astype(np.float32) for _ in range(7)]
    assert native.native_available()
    got = native.stack_batch(imgs)
    np.testing.assert_array_equal(got, np.stack(imgs))
    np.testing.assert_array_equal(got, jnative.stack_batch(imgs))
    u8 = [rng.integers(0, 256, (6, 5, 3), dtype=np.uint8) for _ in range(5)]
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_allclose(native.normalize_batch(u8, mean, std),
                               (np.stack(u8) / 255.0 - mean) / std,
                               rtol=1e-5, atol=1e-5)
    # one multiply-add a value: equal up to the compilers' contraction
    np.testing.assert_allclose(native.normalize_batch(u8, mean, std),
                               jnative.normalize_batch(u8, mean, std),
                               rtol=1e-6, atol=1e-6)


def test_kernel_launch_guard():
    """A launch takes its stream only when its tensor's device is the
    current CUDA device (None: the current one)."""
    from count_pipnet_tpu_torch.ops.cuda import check_current_device
    check_current_device(None, 0)
    check_current_device(1, 1)
    with pytest.raises(RuntimeError, match=r"tensor is on cuda:1 but the "
                       r"current CUDA device is cuda:0"):
        check_current_device(1, 0)


def test_dryrun_multichip_prints_ok(dryrun):
    out, err = dryrun.communicate(timeout=300)
    assert dryrun.returncode == 0, out[-2000:] + err[-3000:]
    assert "dryrun_multichip(2): OK, loss=" in out


def test_world_has_the_explicit_timeout(tmp_path):
    """A world is built with distributed.PG_TIMEOUT (an hour: rank 0's
    visualisations keep the other ranks waiting in a collective), not
    the backend's default; a one-rank gloo world here."""
    import datetime
    import torch.distributed as dist
    from count_pipnet_tpu_torch.parallel import distributed
    assert distributed.PG_TIMEOUT == datetime.timedelta(hours=1)
    assert distributed.maybe_initialize(
        init_method=f"file://{tmp_path}/store", world_size=1, rank=0,
        device_type="cpu")
    try:
        group = dist.distributed_c10d._get_default_group()
        backend = group._get_backend(torch.device("cpu"))
        assert backend.options._timeout == distributed.PG_TIMEOUT
    finally:
        distributed.shutdown()
    assert not distributed.is_initialized()
