"""Count-PIPNet serving forwards: counts and logits without the
[B, H, W, P] prototype maps.

Port of count_pipnet_tpu/models/serving.py:make_serving_fn and of the
gumbel-hard composition that bench.py:82-93 runs on the TPU. Both return
``(clamped_counts [B, P], logits [B, K])``: counts, round and clamp to
[0, max_count], the intermediate layer and ``relu(W)`` over the classes.

* :func:`make_serving_fn`, the deterministic (softmax) path: a backbone
  (the module itself, or the int8 ``quantize`` or K5 ``fused_mlp``
  backbones of models/quantized.py), then K9 (ops/fused_head.py): the
  add-on 1x1 conv, the per-patch softmax and the spatial sum in one
  kernel; any of the five intermediates.
* :func:`make_gumbel_serving_fn`, the gumbel-hard path: one kernel per
  ConvNeXt block (models/quantized.py: fused_block_convnext_apply, int8
  static or dynamic, optionally K10 downsamples), then the gumbel-hard
  counts and the one-hot encoding. With ``num_features == 0`` (the headline
  configuration) the prototypes are the backbone channels and the last
  block runs fused with the head (kernel C), so the last feature plane is
  never stored; with ``num_features > 0`` every block runs kernel A, the
  add-on 1x1 conv is a PyTorch op and the head is kernel B.
* :func:`shard_serving_fn` binds either forward to several devices, data
  parallel: one replica a device, each call split into equal shards.

Each forward runs under ``torch.cuda.device`` of its device: the kernels
launch on the CUDA runtime's current device (ops/cuda/__init__.py:
stream_ptr).
"""

import contextlib
import copy
import itertools

import torch

from ..ops.fused_head import fused_count_head, prepare_count_head
from ..ops.gumbel_head import gumbel_hard_counts
from ..ops.ste import create_modified_encoding
from .quantized import (fused_block_convnext_apply, fused_convnext_apply,
                        prepare_fused_blocks, prepare_fused_mlp,
                        quant_convnext_apply, quantize_convnext_params)

__all__ = ["make_serving_fn", "make_gumbel_serving_fn", "with_seed_counter",
           "shard_serving_fn", "serving_plain_versions"]


def _place(model, state_dict, device):
    if state_dict is not None:
        model.load_state_dict(state_dict)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return model.to(device).eval(), device


def on_device(device):
    """``torch.cuda.device(device)`` for a CUDA device, else a no-op."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def make_serving_fn(model, state_dict=None, device="cuda", *,
                    quantize: bool = False, fused_mlp: bool = False,
                    dtype=torch.bfloat16):
    """Build ``infer(x) -> (clamped_counts, logits)`` for a softmax
    :class:`models.pipnet.CountPIPNet` (the JAX package's
    ``make_serving_fn``).

    The backbone is the module's own f32 forward, or with ``quantize`` its
    int8 pointwise GEMMs (``quant_convnext_apply``), or with ``fused_mlp``
    its block bodies through K5 (``fused_convnext_apply``); the last two
    keep their planes in ``dtype``. The counts are K9 with the add-on's 1x1
    conv, or with the identity and a zero bias at ``num_features=0`` (its
    split bf16 operands made here).
    ``state_dict`` (optional) is loaded into ``model`` first; all weights
    are prepared once, here. ``x`` is [B, H, W, 3] (numpy or tensor); the
    outputs are tensors on ``device``.
    """
    if model.activation != "softmax":
        raise ValueError(
            "serving fast path requires activation='softmax' (gumbel "
            "inference is stochastic by design; use make_gumbel_serving_fn "
            "or the standard forward)")
    model, device = _place(model, state_dict, device)
    backbone = model.backbone
    if quantize:
        qparams = quantize_convnext_params(backbone)

        def features(x):
            return quant_convnext_apply(backbone, qparams, x, dtype=dtype)
    elif fused_mlp:
        mlp = prepare_fused_mlp(backbone)

        def features(x):
            return fused_convnext_apply(backbone, x, dtype=dtype,
                                        prepared=mlp)
    else:
        def features(x):
            return backbone(x)
    conv = model.add_on.conv1x1
    if conv is not None:
        w = conv.weight.detach().reshape(conv.out_channels, -1).float()
        b = conv.bias.detach().float()
    else:
        p = backbone.out_channels
        w = torch.eye(p, device=device)
        b = torch.zeros(p, device=device)
    w, b = w.contiguous(), b.contiguous()
    head = prepare_count_head(w, b)
    clf = model.classification
    w_t = torch.relu(clf.weight.detach()).t().contiguous()   # [D, K]
    bias = None if clf.bias is None else clf.bias.detach()
    max_count = float(model.max_count)

    @torch.inference_mode()
    def infer(x):
        with on_device(device):
            return forward(x)

    def forward(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        counts = fused_count_head(features(x), w, b, prepared=head)
        clamped = torch.clamp(torch.round(counts), 0.0, max_count)
        out = model.intermediate(clamped) @ w_t
        if bias is not None:
            out = out + bias
        return clamped, out

    return infer


def make_gumbel_serving_fn(model, state_dict=None, act_scales=None,
                           device="cuda", *, dtype=torch.bfloat16,
                           int8_min_dim=None, int8_downsample=False):
    """Build ``infer(x, seed, noise=None) -> (clamped_counts, logits)`` for a
    gumbel-activation :class:`models.pipnet.CountPIPNet`.

    ``state_dict`` (optional) is loaded into ``model`` first. The blocks of
    width >= ``int8_min_dim`` run int8: with static scales when
    ``act_scales`` (from :func:`models.quantized.calibrate_act_scales`) are
    given (default width 96), else with dynamic per-row scales (default
    384). ``int8_downsample`` runs the wide stride-1 downsamples through
    K10. Kernel weights are prepared once, here. ``x`` is [B, H, W, 3]
    (numpy or tensor); the outputs are tensors on ``device``. ``noise``
    (optional, [B, H', W', P]) replaces the Gumbel draw from ``seed``
    (parity checks).
    """
    if model.activation != "gumbel_softmax":
        raise ValueError("make_gumbel_serving_fn needs the gumbel_softmax "
                         "activation; the softmax path is make_serving_fn")
    if model.intermediate_type != "onehot":
        raise ValueError("the serving path composes the one-hot encoding; "
                         f"got intermediate {model.intermediate_type!r}")
    model, device = _place(model, state_dict, device)
    if act_scales is not None:
        act_scales = {k: tuple(torch.as_tensor(t, device=device)
                               for t in v) for k, v in act_scales.items()}
    fused_head = model.num_features == 0
    prepared = prepare_fused_blocks(model.backbone, act_scales, int8_min_dim,
                                    fused_head=fused_head,
                                    int8_downsample=int8_downsample)
    clf = model.classification
    w_t = torch.relu(clf.weight.detach()).t().contiguous()   # [D, K]
    bias = None if clf.bias is None else clf.bias.detach()
    max_count = float(model.max_count)

    @torch.inference_mode()
    def infer(x, seed: int, noise=None):
        with on_device(device):
            return forward(x, seed, noise)

    def forward(x, seed, noise):
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


def shard_serving_fn(make_fn, model, devices, state_dict=None, **make_kw):
    """Bind a serving forward to ``devices``, data parallel (the JAX
    package's ``shard_serving_fn`` over a mesh).

    ``make_fn``: :func:`make_serving_fn` or :func:`make_gumbel_serving_fn`,
    called once a device on its own copy of ``model`` (with
    ``state_dict`` and ``make_kw``), so every replica holds its own
    weights, placed once. The returned ``infer(x, seed=None, noise=None)``
    splits the batch into equal shards in device order, runs each replica
    on its shard (under its device), and concatenates the outputs on the
    first device. A gumbel forward's shard i draws from the seed
    ``seed * len(devices) + i``: no two shards of a call, nor of calls with
    different seeds, share a stream; an injected ``noise`` is split with
    the batch, so the result equals the unsharded call's."""
    devices = [torch.device(d) for d in devices]
    replicas = [make_fn(copy.deepcopy(model), state_dict, device=d,
                        **make_kw) for d in devices]
    n = len(devices)

    def infer(x, seed=None, noise=None):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by the "
                             f"{n} serving devices")
        per = x.shape[0] // n
        outs = []
        for i, fn in enumerate(replicas):
            rows = slice(i * per, (i + 1) * per)
            if seed is None and noise is None:
                outs.append(fn(x[rows]))
            else:
                outs.append(fn(x[rows], (seed or 0) * n + i,
                               None if noise is None else noise[rows]))
        return tuple(torch.cat([o[k].to(devices[0]) for o in outs])
                     for k in range(len(outs[0])))

    return infer


def with_seed_counter(infer, first_seed: int = 1):
    """``infer(x, seed)`` -> ``fn(x)`` drawing a fresh seed per call
    (first_seed, first_seed + 1, ...), the way bench.py passes ``i + 1``
    per step. ServingEngine calls its ``infer_fn`` with one argument."""
    seeds = itertools.count(first_seed)

    def fn(x):
        return infer(x, next(seeds))

    return fn


@contextlib.contextmanager
def serving_plain_versions(only=None):
    """Every kernel wrapper of the serving forwards (or those named in
    ``only``) swapped for its plain version, where models/quantized.py and
    this module look them up: a forward built before the block runs the
    plain versions inside it, on any device."""
    import sys

    from ..ops.fused_block import fused_block_plain
    from ..ops.fused_head import fused_count_head_plain
    from ..ops.fused_mlp import fused_ln_mlp_residual_plain
    from ..ops.gumbel_head import (fused_block_gumbel_counts_plain,
                                   gumbel_hard_counts_plain)
    from ..ops.int8_gemm import int8_quant_gemm_plain
    from . import quantized as mq
    ms = sys.modules[__name__]
    swaps = [(mq, "fused_block", fused_block_plain),
             (mq, "fused_block_gumbel_counts",
              fused_block_gumbel_counts_plain),
             (mq, "fused_ln_mlp_residual", fused_ln_mlp_residual_plain),
             (mq, "int8_quant_gemm", int8_quant_gemm_plain),
             (ms, "fused_count_head", fused_count_head_plain),
             (ms, "gumbel_hard_counts", gumbel_hard_counts_plain)]
    swaps = [sw for sw in swaps if only is None or sw[1] in only]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
