"""The port's ServingEngine (count_pipnet_tpu_torch/serving/engine.py) on
the CPU: batching, the padding ladder, deadline flush, result routing and
error propagation, mirroring tests/test_serving_engine.py, plus the
engine around the gumbel-hard and the softmax serving forwards of a tiny
model."""

import time

import numpy as np
import pytest
import torch

from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.pipnet import CountPIPNet
from count_pipnet_tpu_torch.models.quantized import calibrate_act_scales
from count_pipnet_tpu_torch.models.serving import (make_gumbel_serving_fn,
                                                   make_serving_fn,
                                                   with_seed_counter)
from count_pipnet_tpu_torch.serving import ServingEngine, autotune_batch_size

SHAPE = (8, 8, 3)


def _toy_infer(x):
    # per-image function of the input: channel means and a fake "logit"
    m = torch.as_tensor(x).mean(dim=(1, 2))
    return m, m.sum(dim=-1, keepdim=True) * 2.0


def _direct(img):
    m, s = _toy_infer(img[None])
    return m[0].numpy(), s[0].numpy()


def test_results_routed_to_correct_requests():
    rng = np.random.default_rng(0)
    imgs = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(11)]
    with ServingEngine(_toy_infer, SHAPE, batch_sizes=(4, 8),
                       max_wait_ms=5.0) as eng:
        results = [f.result(timeout=30) for f in eng.submit_many(imgs)]
    for img, (m, s) in zip(imgs, results):
        m_ref, s_ref = _direct(img)
        np.testing.assert_allclose(m, m_ref, rtol=1e-6)
        np.testing.assert_allclose(s, s_ref, rtol=1e-6)


def test_padding_ladder_and_stats():
    rng = np.random.default_rng(1)
    # generous deadline: the 3 submits land in one collect window
    with ServingEngine(_toy_infer, SHAPE, batch_sizes=(4, 8),
                       max_wait_ms=250.0) as eng:
        futs = eng.submit_many(
            rng.normal(size=(3,) + SHAPE).astype(np.float32))
        [f.result(timeout=30) for f in futs]
        time.sleep(0.1)                  # let the drainer update stats
        st = eng.stats()
    assert st["requests"] == 3
    assert st["batches"] == 1
    assert st["padded_slots"] == 1       # 3 requests -> ladder size 4
    assert "latency_ms_p50" in st and "latency_ms_p99" in st


def test_deadline_flush_and_stop_flush():
    rng = np.random.default_rng(2)
    img = rng.normal(size=SHAPE).astype(np.float32)
    with ServingEngine(_toy_infer, SHAPE, batch_sizes=(16,),
                       max_wait_ms=20.0) as eng:
        m, _ = eng.submit(img).result(timeout=30)
    np.testing.assert_allclose(m, _direct(img)[0], rtol=1e-6)
    eng = ServingEngine(_toy_infer, SHAPE, batch_sizes=(64,),
                        max_wait_ms=10_000.0).start()
    futs = eng.submit_many(rng.normal(size=(5,) + SHAPE).astype(np.float32))
    eng.stop()                           # flushes the never-full batch
    assert all(np.isfinite(f.result(timeout=30)[0]).all() for f in futs)


def test_errors_and_lifecycle():
    def bad_infer(x):
        raise RuntimeError("boom")

    with ServingEngine(bad_infer, SHAPE, batch_sizes=(1,),
                       max_wait_ms=1.0) as eng:
        fut = eng.submit(np.zeros(SHAPE, np.float32))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
        with pytest.raises(ValueError):
            eng.submit(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(RuntimeError):
        eng.submit(np.zeros(SHAPE, np.float32))     # stopped
    assert eng._stats["latencies_ms"].maxlen == 10000


def test_autotune_returns_best():
    out = autotune_batch_size(_toy_infer, SHAPE, candidates=(2, 4), iters=2)
    assert out["best"] in (2, 4) and set(out["throughput"]) == {2, 4}


def test_engine_serves_gumbel_forward():
    """Each request's result equals its row of the batched forward (one
    batch of 8, seed 1 from the counter); stats count it exactly."""
    torch.manual_seed(0)
    stages = ((32, 1), (64, 1))
    model = CountPIPNet(num_classes=6, num_prototypes=64,
                        backbone=ConvNeXtFeatures(stages, 40, num_stages=3))
    x = np.random.default_rng(4).normal(size=(8, 32, 32, 3)) \
        .astype(np.float32)
    scales = calibrate_act_scales(model.backbone, torch.from_numpy(x))
    infer = make_gumbel_serving_fn(model, act_scales=scales, device="cpu",
                                   dtype=torch.float32, int8_min_dim=64)
    with ServingEngine(with_seed_counter(infer), (32, 32, 3),
                       batch_sizes=(4, 8), max_wait_ms=250.0) as eng:
        results = [f.result(timeout=60) for f in eng.submit_many(x)]
        time.sleep(0.1)
        st = eng.stats()
    counts, logits = infer(x, 1)
    for i, (c, lg) in enumerate(results):
        assert c.shape == (64,) and lg.shape == (6,)
        np.testing.assert_array_equal(c, counts[i].numpy())
        np.testing.assert_allclose(lg, logits[i].numpy(), rtol=1e-6)
    assert (st["requests"], st["batches"], st["padded_slots"]) == (8, 1, 0)


def test_engine_serves_softmax_forward():
    """make_serving_fn is an infer_fn as it is: 5 single-image requests,
    padded to a batch of 8, each answered with its row of the batched
    deterministic forward (1e-6)."""
    torch.manual_seed(1)
    model = CountPIPNet(num_classes=6, num_prototypes=64,
                        backbone=ConvNeXtFeatures(((32, 1), (64, 1)), 40,
                                                  num_stages=3),
                        activation="softmax")
    infer = make_serving_fn(model, device="cpu", quantize=True)
    x = np.random.default_rng(6).normal(size=(5, 32, 32, 3)) \
        .astype(np.float32)
    with ServingEngine(infer, (32, 32, 3), batch_sizes=(8,),
                       max_wait_ms=250.0) as eng:
        results = [f.result(timeout=60) for f in eng.submit_many(x)]
    counts, logits = infer(x)
    for i, (c, lg) in enumerate(results):
        assert c.shape == (64,) and lg.shape == (6,)
        np.testing.assert_allclose(c, counts[i].numpy(), rtol=1e-6)
        np.testing.assert_allclose(lg, logits[i].numpy(), rtol=1e-6,
                                   atol=1e-6)
