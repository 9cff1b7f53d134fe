"""The port's ConvNeXt trunk under bf16 autocast keeps its residual stream
in bf16, as the JAX package's ``ConvNeXtFeatures(dtype=bfloat16)`` does.

flax casts each block's layer scale to the branch's dtype and adds the
residual in that dtype, and its LayerNorm returns its compute dtype. So
every stage of the JAX trunk (the stem, each block stage, each
downsample) returns bf16. Here the port's trunk, on the same parameters
through the bridge, runs each block route under ``torch.autocast`` to
bf16: the plain blocks, ``--fused_dwconv``, ``--fused_blocks`` and
``--fused_whole_blocks``. Each stage must return bf16, and each must equal
the JAX stage's output to 2e-2 of that stage's largest magnitude. That is
a few bf16 steps of the stream: the two sides round the same sums in
other orders. In training mode the same holds with the stochastic-depth
masks injected into both sides. Small widths; inputs from a numpy seed."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu_torch.models.convert import backbone_from_jax_params
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures

STAGES = ((32, 1), (64, 1), (64, 2), (96, 2))
NUM_STAGES = 7          # stem, 4 block stages, 3 downsamples
THRESHOLD = 40          # the last two downsamples at stride 1
TOL = 2e-2              # of each stage's largest magnitude
ROUTES = {"eager": {}, "fused_dwconv": {"fused_dwconv": True},
          "fused_blocks": {"fused_mlp": True},
          "fused_whole_blocks": {"fused_whole_block": True}}


def _trunks(route):
    """The flax trunk (bf16 compute) and the port's on the same
    parameters, layer scales at 0.2 so that every branch shows."""
    flags = ROUTES[route]
    jm = JFeatures(stage_settings=STAGES, stride_threshold=THRESHOLD,
                   num_stages=NUM_STAGES, dtype=jnp.bfloat16, **flags)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))["params"])
    params = {k: (dict(v, layer_scale=np.full_like(v["layer_scale"], 0.2))
                  if "layer_scale" in v else v) for k, v in params.items()}
    tm = ConvNeXtFeatures(STAGES, THRESHOLD, NUM_STAGES, **flags)
    tm.load_state_dict(backbone_from_jax_params(params))
    return jm, params, tm


def _jax_stages(jm, params, x, train):
    """The JAX trunk's stage outputs in the port's ``features`` order: the
    stem, then each block stage's last block or a downsample."""
    apply = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, deterministic=not train,
        rngs={"droppath": jax.random.PRNGKey(0)},
        capture_intermediates=True, mutable=["intermediates"]))
    inter = apply(params, jnp.asarray(x))[1]["intermediates"]
    out = []
    for i in range(2 * len(STAGES)):
        blocks = sorted(k for k in inter if k.startswith(f"features_{i}_"))
        key = blocks[-1] if blocks else f"features_{i}"
        out.append(inter[key]["__call__"][0])
    return out


def _port_stages(tm, x, masks):
    """The port's stage outputs under bf16 autocast, NHWC; ``masks``
    (indexed by block id) applies stochastic depth."""
    h = torch.from_numpy(x).permute(0, 3, 1, 2)
    out, block_id = [], 0
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        for mod in tm.features:
            if hasattr(mod[0], "sd_prob"):
                for blk in mod:
                    mask = None
                    if masks is not None and blk.sd_prob > 0.0:
                        mask = torch.from_numpy(masks[block_id])
                    h = blk(h, mask)
                    block_id += 1
            else:
                h = mod(h)
            out.append(h.permute(0, 2, 3, 1))
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_stages_stay_bf16_and_match_jax(monkeypatch, route, train):
    jm, params, tm = _trunks(route)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    masks = None
    if train:
        # one mask a block, drawn by numpy; JAX draws in block order, so
        # each of its bernoulli calls takes the next block's mask
        masks = [(rng.random((4, 1, 1, 1)) < 0.5).astype(np.float32)
                 for _ in tm.blocks()]
        masks[0][:] = 1.0  # block 0 has no stochastic depth
        cycle = itertools.cycle(masks[1:])
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(
                                next(cycle) > 0))
    ref = _jax_stages(jm, params, x, train)
    got = _port_stages(tm, x, masks)
    assert len(got) == len(ref) == 2 * len(STAGES)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert r.dtype == jnp.bfloat16, (i, r.dtype)
        assert g.dtype == torch.bfloat16, (route, i, g.dtype)
        r = np.asarray(r, np.float32)
        err = np.abs(g.float().numpy() - r).max() / np.abs(r).max()
        assert err <= TOL, (route, i, err)
