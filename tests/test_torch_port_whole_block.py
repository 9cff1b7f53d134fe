"""The whole-block training route (``--fused_whole_blocks``) and the
depthwise route (``--fused_dwconv``) against the JAX package:

* ``block_body_plain`` against ``_block_body_xla``;
* ``fused_block_ad`` (kernel A's plain version forward on the CPU, the
  recompute backward) against ``jax.vjp`` of ``fused_block_ad(...,
  use_pallas=False)``: the output and all ten gradients;
* kernel A's plain version (the training forward's arithmetic) against the
  Pallas ``fused_block_apply(int8=False, interpret=True)`` on ragged planes,
  f32 and bf16;
* ``CNBlock`` on the whole-block, the depthwise and the depthwise + fused
  MLP routes against the flax ``CNBlock`` with the same flags, on the same
  bridged parameters: output and every gradient.

Small widths; inputs from numpy seeds. The port takes torch-layout
weights, JAX the flax layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models.convnext import CNBlock as JCNBlock
from count_pipnet_tpu.ops.pallas import fused_block as jfb
from count_pipnet_tpu_torch.models.convert import backbone_from_jax_params
from count_pipnet_tpu_torch.models.convnext import CNBlock
from count_pipnet_tpu_torch.ops.fused_block import (block_body_plain,
                                                    fused_block,
                                                    fused_block_ad,
                                                    prepare_block)

NAMES = ("x", "dw_weight", "dw_bias", "ln_weight", "ln_bias", "pw1_weight",
         "pw1_bias", "pw2_weight", "pw2_bias", "layer_scale")


def _setup(shape, seed):
    """(x [B, H, W, C], the JAX package's ten block arguments as numpy,
    cotangent)."""
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def n(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)

    jargs = [n(*shape), n(7, 7, 1, c, sc=0.1), n(c, sc=0.1),
             1 + n(c, sc=0.1), n(c, sc=0.1), n(c, 4 * c, sc=0.2),
             n(4 * c, sc=0.1), n(4 * c, c, sc=0.2), n(c, sc=0.1),
             n(c, sc=0.3)]
    return jargs, n(*shape, sc=0.5)


def _torch_args(jargs):
    """The JAX package's block arguments -> the port's (torch layout)."""
    x, dwk, dwb, ls, lb, w1, b1, w2, b2, gamma = jargs
    t = lambda a: torch.tensor(np.ascontiguousarray(a))  # noqa: E731
    return [t(x), t(dwk.transpose(3, 2, 0, 1)), t(dwb), t(ls), t(lb),
            t(w1.T), t(b1), t(w2.T), t(b2), t(gamma)]


def _to_jax_layout(name, g):
    if name == "dw_weight":
        return g.transpose(2, 3, 1, 0)
    if name in ("pw1_weight", "pw2_weight"):
        return g.T
    return g


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 9, 9, 16), (1, 14, 13, 32)])
def test_block_body_plain_matches_xla(shape, xdt):
    """Same casts as ``_block_body_xla`` (f32 conv and LayerNorm, bf16 GEMM
    operands and results): the branch (out - x) within 1e-2 of its largest
    value (a bf16 GEMM result may round the other way) and the output in
    x's dtype."""
    jargs, _ = _setup(shape, seed=shape[-1])
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[xdt]
    xj = jnp.asarray(jargs[0], jdt)
    ta = _torch_args(jargs)
    ta[0] = torch.tensor(np.asarray(xj, np.float32)).to(tdt)
    got = block_body_plain(*ta)
    assert got.dtype == tdt and got.shape == shape
    ref = np.asarray(jfb._block_body_xla(xj, *jargs[1:], 1e-6), np.float32)
    x32 = np.asarray(xj, np.float32)
    assert _rel(got.float().numpy() - x32, ref - x32) < 1e-2


def test_fused_block_ad_matches_jax_vjp():
    """Forward: kernel A's plain version (f32 sums of bf16 GEMM operands)
    against the XLA body that also rounds the GEMM results to bf16, the
    branch within 2e-2 of its largest value. Backward: both recompute the
    same body, so each of the ten gradients within 5e-3 of its largest
    value."""
    jargs, g = _setup((2, 9, 9, 32), seed=3)
    ta = [t.requires_grad_(True) for t in _torch_args(jargs)]
    out = fused_block_ad(*ta)
    out.backward(torch.from_numpy(g))

    def f(*a):
        return jfb.fused_block_ad(*a, 1e-6, False)

    out_j, vjp = jax.vjp(f, *map(jnp.asarray, jargs))
    x = jargs[0]
    assert _rel(out.detach().numpy() - x, np.asarray(out_j) - x) < 2e-2
    for name, t, gj in zip(NAMES, ta, vjp(jnp.asarray(g))):
        got = _to_jax_layout(name, t.grad.numpy())
        assert got.shape == np.shape(gj), name
        assert _rel(got, gj) < 5e-3, (name, _rel(got, gj))


def test_fused_block_ad_frozen_parameters_get_no_gradient():
    """Only what requires a gradient gets one (frozen parameter groups)."""
    jargs, g = _setup((1, 6, 11, 32), seed=4)
    ta = _torch_args(jargs)
    ta[0].requires_grad_(True)
    ta[5].requires_grad_(True)
    fused_block_ad(*ta).backward(torch.from_numpy(g))
    assert ta[0].grad is not None and ta[5].grad is not None
    assert all(t.grad is None for i, t in enumerate(ta) if i not in (0, 5))


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 14, 13, 32), (1, 6, 11, 64)])
def test_training_forward_matches_pallas_interpret(shape, xdt):
    """Kernel A's plain version, the CPU forward of ``fused_block_ad``,
    against the Pallas ``fused_block_apply`` in bf16 mode on ragged planes:
    f32 planes, the branch within 1e-2 of its largest value; bf16 planes,
    the output within 1e-2 of its largest value (both round it to
    bf16)."""
    jargs, _ = _setup(shape, seed=shape[-1] + 5)
    b, h, w, c = shape
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[xdt]
    xj = jnp.asarray(jargs[0], jdt)
    ta = _torch_args(jargs)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(tdt)
    got = fused_block(xt, prepare_block(*ta[1:])).float().numpy()
    ref = np.asarray(jfb.fused_block_apply(
        xj.reshape(b, h * w, c), h, w, *jargs[1:], int8=False,
        interpret=True), np.float32).reshape(shape)
    x32 = np.asarray(xj, np.float32)
    if xdt == "f32":
        assert _rel(got - x32, ref - x32) < 1e-2
    else:
        assert _rel(got, ref) < 1e-2


ROUTES = {"whole": dict(fused_whole_block=True),
          "dwconv": dict(fused_dwconv=True),
          "dwconv_mlp": dict(fused_dwconv=True, fused_mlp=True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_cnblock_routes_match_flax(route):
    """The port's CNBlock against the flax CNBlock on the same route and
    the same bridged parameters (layer scale 0.2, so the branch shows):
    the output to 2e-2 of the branch's largest value on the kernel-A and
    K5 routes (their plain versions keep the GEMM results in f32, the XLA
    bodies round them to bf16) and 1e-4 on the depthwise-only route (f32
    throughout, sums in another order); the
    gradient of sum(tanh(out)) for the input and every parameter within
    1e-2 of each one's largest value (1e-4 on the depthwise-only route)."""
    flags = ROUTES[route]
    c = 32
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 9, c)).astype(np.float32)
    jm = JCNBlock(c, **flags)
    params = jax.device_get(jm.init(jax.random.PRNGKey(2),
                                    jnp.asarray(x))["params"])
    params = dict(params, layer_scale=np.full((c,), 0.2, np.float32))
    tm = CNBlock(c, **flags)
    sd = backbone_from_jax_params({"features_1_block_0": params})
    tm.load_state_dict({k[len("features.1.0."):]: v for k, v in sd.items()})

    def loss_j(p, xx):
        return jnp.sum(jnp.tanh(jm.apply({"params": p}, xx)))

    (out_j, (gp_j, gx_j)) = (jm.apply({"params": params}, jnp.asarray(x)),
                             jax.grad(loss_j, argnums=(0, 1))(
                                 params, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.tanh(out).sum().backward()
    exact = route == "dwconv"
    assert _rel(out.detach().numpy() - x, np.asarray(out_j) - x) < (
        1e-4 if exact else 2e-2)
    tol = 1e-4 if exact else 1e-2
    assert _rel(xt.grad.numpy(), gx_j) < tol
    got = {jax_key: tm.state_dict(keep_vars=True)[k].grad
           for k, jax_key in _PARAM_KEYS.items()}
    for (scope, leaf), gt in got.items():
        want = np.asarray(gp_j[scope][leaf] if leaf else gp_j[scope])
        a = gt.numpy()
        if scope == "dwconv" and leaf == "kernel":
            a = a.transpose(2, 3, 1, 0)
        elif leaf == "kernel":
            a = a.T
        assert _rel(a.reshape(want.shape), want) < tol, (scope, leaf)


_PARAM_KEYS = {"block.0.weight": ("dwconv", "kernel"),
               "block.0.bias": ("dwconv", "bias"),
               "block.2.weight": ("norm", "scale"),
               "block.2.bias": ("norm", "bias"),
               "block.3.weight": ("pw1", "kernel"),
               "block.3.bias": ("pw1", "bias"),
               "block.5.weight": ("pw2", "kernel"),
               "block.5.bias": ("pw2", "bias"),
               "layer_scale": ("layer_scale", None)}
