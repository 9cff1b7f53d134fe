"""Serving a trained run's checkpoint (count_pipnet_tpu_torch/scripts/
serve_trained.py) on the CPU, where the kernels' plain versions run.

A tiny gumbel Count-PIPNet (convnext_tiny_26 cut to its first stage: three
blocks of 96 at 8x8, 32x32 images, 8 prototypes behind the add-on's 1x1
conv, whose bias spreads the clamped counts over 0-3, 3 classes, layer
scales 0.1 so that the blocks show) is written as a port run directory by
the port's own checkpoint code, beside a small geometric_shapes dataset of
PNGs. ``serve_trained`` loads it and serves the
test split on routes 1, 2 and 4 (bf16, int8-static, dynamic int8): their
plain versions give the eager model's counts, and under the same noise,
on the parameters carried across by models/convert.py, the JAX package's
counts and logits from its ``fused_block_convnext_apply`` and
``gumbel_hard_counts`` in interpret mode (tests/test_torch_port_slice.py's
tolerances: counts agreement >= 0.99, logit relative error < 0.05).
The static scales' images are a seeded draw over the training split.
``expected_launches`` reads the flagship's launches a forward off the
prepared weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from count_pipnet_tpu.models import quantized as jq
from count_pipnet_tpu.ops.pallas import gumbel_head as jgh
from count_pipnet_tpu.ops.ste import create_modified_encoding as jenc
from count_pipnet_tpu_torch.config import build_parser, save_args
from count_pipnet_tpu_torch.models.convert import to_jax_params
from count_pipnet_tpu_torch.models.convnext import convnext_tiny_26_features
from count_pipnet_tpu_torch.models.pipnet import get_count_network
from count_pipnet_tpu_torch.models.quantized import block_scopes
from count_pipnet_tpu_torch.scripts import serve_trained as st
from count_pipnet_tpu_torch.utils.checkpoint import CheckpointManager

CLASSES, TRAIN, TEST, SIDE = 3, 4, 3, 32
ROUTES = ("bf16", "int8_static", "int8_dynamic")
FLAGS = ["--model", "count_pipnet", "--dataset", "geometric_shapes",
         "--net", "convnext_tiny_26", "--use_mid_layers", "--num_stages", "1",
         "--image_size", str(SIDE), "--num_features", "8", "--max_count", "3",
         "--use_ste", "True", "--activation", "gumbel_softmax",
         "--intermediate_layer", "onehot", "--num_workers", "2",
         "--seed", "1", "--fused_blocks", "--disable_cuda"]


def _write_images(root, split, n, rng):
    for c in range(CLASSES):
        d = root / "data" / "geometric_shapes" / "dataset" / split / f"c{c}"
        d.mkdir(parents=True)
        for i in range(n):
            px = rng.integers(0, 256, size=(SIDE, SIDE, 3), dtype=np.uint8)
            Image.fromarray(px).save(d / f"{i}.png")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    _write_images(root, "train", TRAIN, rng)
    _write_images(root, "test", TEST, rng)
    run = root / "run"
    args = build_parser().parse_args(FLAGS + ["--log_dir", str(run)])
    torch.manual_seed(0)
    model, n_protos = get_count_network(CLASSES, args, max_count=3,
                                        use_ste=True)
    assert n_protos == 8
    with torch.no_grad():
        for blk in model.backbone.blocks():
            blk.layer_scale.fill_(0.1)
        # an add-on that prefers some prototypes, as a trained one does,
        # so that the clamped counts spread over 0-3 (at the init's zero
        # bias nearly every count clamps to 3)
        model.add_on.conv1x1.bias.copy_(torch.linspace(-3.0, 3.0, 8))
        model.classification.weight.copy_(torch.from_numpy(
            rng.uniform(0, 1, size=(CLASSES, 24)).astype(np.float32)))
    CheckpointManager(args).save_best_checkpoint(model.state_dict(), {}, 5,
                                                 0.5)
    save_args(args, str(run / "metadata"))
    results = st.serve_trained(str(run), ROUTES, device="cpu", batch_size=4,
                               basepath=str(root), keep=True)
    _, x_cal = st.run_data(args, basepath=str(root))
    return dict(results=results, x_cal=np.asarray(x_cal),
                params=to_jax_params(model.state_dict()))


def test_serve_trained_loads_the_run_and_serves_the_test_split(served):
    for route in ROUTES:
        res = served["results"][route]
        out = res["outputs"]
        assert res["images"] == CLASSES * TEST and res["batches"] == 3
        assert out["x"].shape == (CLASSES * TEST, SIDE, SIDE, 3)
        assert out["noise"].shape == (CLASSES * TEST, 8, 8, 8)
        # the loader's order: the classes in turn
        assert out["labels"].tolist() == [c for c in range(CLASSES)
                                          for _ in range(TEST)]
        # nothing launches on the CPU, so nothing is expected to
        assert res["launches"] == {} and res["expected_launches"] == {}
        c, o = out["kernels"]
        assert c.shape == (9, 8) and o.shape == (9, CLASSES)
        assert res["vs_plain"] == {"counts_agree": 1.0, "logit_rel_err": 0.0}


@pytest.mark.parametrize("route", ROUTES)
def test_plain_routes_give_the_eager_counts(served, route):
    res = served["results"][route]
    c, o = res["outputs"]["plain"]
    c_r, o_r = res["outputs"]["eager"]
    agree, rel = st.agreement(c, o, c_r, o_r)
    assert (agree, rel) == (res["plain_vs_eager"]["counts_agree"],
                            res["plain_vs_eager"]["logit_rel_err"])
    assert agree >= 0.99 and rel < 0.05, (agree, rel)
    assert res["top1_agree_eager"] >= 8 / 9


def _jax_route(params, x, noise, route, x_cal):
    kw = dict(stride_threshold=100, num_stages=1)
    opts = st.route_options(route, None)
    if route == "int8_static":
        opts["act_scales"] = jq.calibrate_act_scales(
            params["backbone"], jnp.asarray(x_cal), **kw)
    feats = jq.fused_block_convnext_apply(
        params["backbone"], jnp.asarray(x), dtype=jnp.bfloat16,
        interpret=True, **kw, **opts)
    conv = params["add_on"]["conv1x1"]
    logits = (jnp.asarray(feats, jnp.float32)
              @ jnp.asarray(conv["kernel"]).reshape(96, 8)
              + jnp.asarray(conv["bias"]))
    counts = np.asarray(jgh.gumbel_hard_counts(
        logits, 0, noise=jnp.asarray(noise), interpret=True))
    clamped = np.clip(np.round(counts), 0.0, 3.0)
    enc = np.asarray(jenc(jnp.asarray(clamped), 3)).reshape(len(x), -1)
    w = np.asarray(params["classification"]["weight"])
    return clamped, enc @ np.maximum(w, 0.0).T


@pytest.mark.parametrize("route", ROUTES)
def test_routes_match_jax(served, route):
    out = served["results"][route]["outputs"]
    cj, oj = _jax_route(served["params"], out["x"].numpy(),
                        out["noise"].numpy(), route, served["x_cal"])
    c, o = (t.numpy() for t in out["kernels"])
    assert np.mean(c == cj) >= 0.99
    assert np.abs(o - oj).max() / (np.abs(oj).max() + 1e-9) < 0.05


def test_calibration_images_span_the_classes(served):
    """The static scales' 64 images are a seeded draw over the whole
    training split, not its first images, which the loader gives sorted by
    class: on the canonical split (9 classes of 100) every class is drawn,
    the same indices every time; on the tiny split (12 < 64) all of it."""
    idx = st.calibration_indices(900)
    assert len(set(idx)) == 64 and idx == sorted(idx)
    assert idx == st.calibration_indices(900)
    assert {i // 100 for i in idx} == set(range(9))
    assert st.calibration_indices(CLASSES * TRAIN) == list(
        range(CLASSES * TRAIN))
    assert served["x_cal"].shape == (CLASSES * TRAIN, SIDE, SIDE, 3)


def test_expected_launches_of_the_flagship():
    """convnext_tiny_26 at 7 stages: 18 blocks (6 of width < 384), the
    stride-1 downsamples 192 -> 384 and 384 -> 768."""
    bb = convnext_tiny_26_features(7)
    scales = {s: (torch.ones(c), torch.ones(4 * c))
              for s, _, _, c in block_scopes(bb)}

    def want(route, num_features):
        return st.expected_launches(
            bb, num_features, **st.route_options(route, scales))

    assert want("bf16", 256) == {"fused_block": 18, "gumbel_hard_counts": 1}
    assert want("int8_static", 256) == want("bf16", 256)
    assert want("int8_downsample", 256) == {
        "fused_block": 18, "gumbel_hard_counts": 1, "int8_quant_gemm": 2}
    assert want("int8_dynamic", 256) == {
        "fused_block": 6, "fused_block_int8_dyn": 12,
        "gumbel_hard_counts": 1}
    # no add-on: the last block is kernel C (bf16 in the dynamic route)
    assert want("int8_dynamic", 0) == {
        "fused_block": 6, "fused_block_int8_dyn": 11,
        "fused_block_gumbel_counts": 1}
    assert want("int8_downsample", 0) == {
        "fused_block": 17, "fused_block_gumbel_counts": 1,
        "int8_quant_gemm": 2}


def test_expected_launches_of_the_canonical_model():
    """The canonical experiment's 3-stage mid-layer model: blocks of 96 and
    192, one stride-2 downsample (no K10), 16 prototypes behind K4; no
    block reaches the dynamic mode's 384."""
    bb = convnext_tiny_26_features(3)
    scales = {s: (torch.ones(c), torch.ones(4 * c))
              for s, _, _, c in block_scopes(bb)}
    for route in st.ROUTES:
        assert st.expected_launches(
            bb, 16, **st.route_options(route, scales)) == {
            "fused_block": 6, "gumbel_hard_counts": 1}, route


def test_serve_trained_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.serve_trained(str(tmp_path))
