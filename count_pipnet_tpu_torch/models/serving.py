"""Gumbel-hard Count-PIPNet serving forward.

The composition bench.py:82-93 runs on the TPU, in PyTorch: the backbone
with one kernel per ConvNeXt block (models/quantized.py), the gumbel-hard
counts, round and clamp to [0, max_count], the modified one-hot encoding
and ``relu(W)`` over the classes. It returns ``(clamped_counts [B, P],
logits [B, K])`` and never builds the [B, H, W, P] prototype maps.

* ``num_features == 0`` (the headline configuration): the prototypes are
  the backbone channels, and the last block runs fused with the head
  (kernel C): the last feature plane is never stored.
* ``num_features > 0``: every block runs kernel A, the add-on 1x1 conv is a
  PyTorch op, and the head is kernel B.

The softmax serving path (``make_serving_fn`` with the fused count head,
kernel 9) is ROADMAP Queue 2 item 9.
"""

import itertools

import torch

from ..ops.gumbel_head import gumbel_hard_counts
from ..ops.ste import create_modified_encoding
from .quantized import fused_block_convnext_apply, prepare_fused_blocks

__all__ = ["make_gumbel_serving_fn", "with_seed_counter"]


def make_gumbel_serving_fn(model, state_dict=None, act_scales=None,
                           device="cuda", *, dtype=torch.bfloat16,
                           int8_min_dim=None):
    """Build ``infer(x, seed, noise=None) -> (clamped_counts, logits)`` for a
    gumbel-activation :class:`models.pipnet.CountPIPNet`.

    ``state_dict`` (optional) is loaded into ``model`` first; ``act_scales``
    from :func:`models.quantized.calibrate_act_scales` switch the blocks of
    width >= ``int8_min_dim`` (default 96) to int8. Kernel weights are
    prepared once, here. ``x`` is [B, H, W, 3] (numpy or tensor); the
    outputs are tensors on ``device``. ``noise`` (optional, [B, H', W', P])
    replaces the Gumbel draw from ``seed`` (parity checks).
    """
    if model.activation != "gumbel_softmax":
        raise ValueError("make_gumbel_serving_fn needs the gumbel_softmax "
                         "activation; the softmax serving path is not "
                         "ported yet")
    if model.intermediate_type != "onehot":
        raise ValueError("the serving path composes the one-hot encoding; "
                         f"got intermediate {model.intermediate_type!r}")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    device = torch.device(device)
    model = model.to(device).eval()
    if act_scales is not None:
        act_scales = {k: tuple(torch.as_tensor(t, device=device)
                               for t in v) for k, v in act_scales.items()}
    fused_head = model.num_features == 0
    prepared = prepare_fused_blocks(model.backbone, act_scales, int8_min_dim,
                                    fused_head=fused_head)
    clf = model.classification
    w_t = torch.relu(clf.weight.detach()).t().contiguous()   # [D, K]
    bias = None if clf.bias is None else clf.bias.detach()
    max_count = float(model.max_count)

    @torch.inference_mode()
    def infer(x, seed: int, noise=None):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        if fused_head:
            counts = fused_block_convnext_apply(
                model.backbone, x, dtype=dtype, prepared=prepared,
                gumbel_head={"seed": seed, "noise": noise})
        else:
            feats = fused_block_convnext_apply(
                model.backbone, x, dtype=dtype, prepared=prepared)
            logits = model.add_on.logits(feats.float()).contiguous()
            counts = gumbel_hard_counts(logits, seed, noise)
        clamped = torch.clamp(torch.round(counts), 0.0, max_count)
        enc = create_modified_encoding(clamped, model.max_count)
        out = enc.reshape(enc.shape[0], -1) @ w_t
        if bias is not None:
            out = out + bias
        return clamped, out

    return infer


def with_seed_counter(infer, first_seed: int = 1):
    """``infer(x, seed)`` -> ``fn(x)`` drawing a fresh seed per call
    (first_seed, first_seed + 1, ...), the way bench.py passes ``i + 1``
    per step. ServingEngine calls its ``infer_fn`` with one argument."""
    seeds = itertools.count(first_seed)

    def fn(x):
        return infer(x, next(seeds))

    return fn
