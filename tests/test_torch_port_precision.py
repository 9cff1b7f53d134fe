"""The precision of the reduced-precision gumbel serving method at larger
weights, on the JAX side and on the port's, on the CPU (ROADMAP Queue 3).

The model is ``convnext_tiny_26`` with all four stages at their full widths
(96/192/384/768, blocks 3/3/9/3, stride surgery at 100), 8 images at 64x64
(planes 16²x96, 8²x192, 7²x384, 6²x768), with the larger weights that
failed the bench.py:137-185 limits at 224² (std 0.1, LayerNorm scales
1 + N(0, 0.1), layer scales N(0, 0.1); everything from a numpy seed). The
method is ``fused_block_convnext_apply`` with bf16 planes, int8-static
blocks (``act_scales`` calibrated on 4 images) and the fused gumbel-hard
head under injected noise; its reference is the same model's f32 forward
(flax's own on the JAX side, the port's eager module on the port's, erf
GELU, no quantization) under the same noise, then the argmax counts, the
clamp to [0, 3], the one-hot encoding and relu(W). Each side reads the
bench.py protocol: the counts agreement and the logit relative error of
the method against its reference. The JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions.

The two readings are held to each other: agreement within 0.01, logit
relative error within 25 % of the larger. Both sides quantize the same
values with the same rules, but bf16 rounding in XLA under ``jit``
(excess precision) and in PyTorch (after every op) differs, and a flipped
rounding moves one patch's argmax, so the readings can differ by a few
counts; 0.01 is 61 of the 6144 counts. With 2 images a handful of
flipped counts set the logit error alone (0.144 against 0.243 on one
seed); 8 images cost no more time, since compiling the interpret-mode
kernels dominates. Readings: ROADMAP.md Queue 3 item 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_port_slice import _classify

from count_pipnet_tpu.models import quantized as jq
from count_pipnet_tpu.models.convnext import CONVNEXT_TINY_STAGES
from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu_torch.models import quantized as tq
from count_pipnet_tpu_torch.models.convert import backbone_from_jax_params
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures

THRESHOLD = 100
STD = 0.1
N_IMAGES = 8


def _large_weights(rng, stages=CONVNEXT_TINY_STAGES):
    """A ConvNeXtFeatures parameter tree in flax's layout, drawn from
    ``rng``: every leaf N(0, STD), LayerNorm scales 1 + N(0, STD), layer
    scales N(0, STD)."""
    n = lambda *s: (rng.normal(size=s) * STD).astype(np.float32)  # noqa
    ln = lambda c: {"scale": 1.0 + n(c), "bias": n(c)}  # noqa: E731
    c0 = stages[0][0]
    tree = {"features_0": {"conv": {"kernel": n(4, 4, 3, c0), "bias": n(c0)},
                           "norm": ln(c0)}}
    for k, (dim, n_blocks) in enumerate(stages):
        for j in range(n_blocks):
            tree[f"features_{2 * k + 1}_block_{j}"] = {
                "dwconv": {"kernel": n(7, 7, 1, dim), "bias": n(dim)},
                "norm": ln(dim),
                "pw1": {"kernel": n(dim, 4 * dim), "bias": n(4 * dim)},
                "pw2": {"kernel": n(4 * dim, dim), "bias": n(dim)},
                "layer_scale": n(dim)}
        if k + 1 < len(stages):
            nxt = stages[k + 1][0]
            tree[f"features_{2 * k + 2}"] = {
                "norm": ln(dim),
                "conv": {"kernel": n(2, 2, dim, nxt), "bias": n(nxt)}}
    return tree


def _readings(counts, logits, ref_counts, ref_logits):
    return (float(np.mean(counts == ref_counts)),
            float(np.abs(logits - ref_logits).max()
                  / (np.abs(ref_logits).max() + 1e-9)))


def test_method_loses_the_same_on_both_sides():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_IMAGES, 64, 64, 3)).astype(np.float32)
    x_cal = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    noise = rng.gumbel(size=(N_IMAGES, 6, 6, 768)).astype(np.float32)
    jm = JFeatures(CONVNEXT_TINY_STAGES, THRESHOLD, num_stages=7)
    bb = _large_weights(rng)
    w = (rng.uniform(-1, 1, size=(200, 768 * 3))
         / np.sqrt(768 * 3)).astype(np.float32)
    kw = dict(stride_threshold=THRESHOLD, num_stages=7)

    # JAX: the Pallas serving method against flax's f32 forward
    feats_j = np.asarray(jm.apply({"params": bb}, jnp.asarray(x),
                                  deterministic=True))
    scales_j = jq.calibrate_act_scales(bb, jnp.asarray(x_cal), **kw)
    counts_j = np.asarray(jq.fused_block_convnext_apply(
        bb, jnp.asarray(x), act_scales=scales_j,
        gumbel_head={"seed": 0, "noise": jnp.asarray(noise)},
        interpret=True, **kw))

    # the port: its serving method against its eager f32 module
    tm = ConvNeXtFeatures(CONVNEXT_TINY_STAGES, THRESHOLD, 7).eval()
    tm.load_state_dict(backbone_from_jax_params(bb))
    with torch.no_grad():
        feats_t = tm(torch.from_numpy(x)).numpy()
    scales_t = tq.calibrate_act_scales(tm, torch.from_numpy(x_cal))
    counts_t = tq.fused_block_convnext_apply(
        tm, torch.from_numpy(x), act_scales=scales_t,
        gumbel_head={"noise": torch.from_numpy(noise)}).numpy()

    assert feats_j.shape == feats_t.shape == (N_IMAGES, 6, 6, 768)
    np.testing.assert_array_equal(counts_j.sum(1), 36.0)
    np.testing.assert_array_equal(counts_t.sum(1), 36.0)
    read = {}
    for side, feats, counts in (("jax", feats_j, counts_j),
                                ("port", feats_t, counts_t)):
        winner = np.argmax(feats + noise, axis=-1).reshape(N_IMAGES, -1)
        ref = np.stack([np.bincount(r, minlength=768) for r in winner])
        read[side] = _readings(*_classify(counts, w),
                               *_classify(ref.astype(np.float32), w))
    print("counts agreement, logit rel err against the f32 forward:", read)
    (a_j, e_j), (a_t, e_t) = read["jax"], read["port"]
    assert abs(a_j - a_t) <= 0.01, read
    assert abs(e_j - e_t) <= 0.25 * max(e_j, e_t), read
