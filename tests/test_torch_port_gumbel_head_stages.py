"""Kernel C's stages (count_pipnet_tpu_torch/ops/gumbel_head.py) on the CPU:
the argmax key that GEMM 2's head epilogue leaves for each row
(``block_head_keys_plain``) and the count kernel's
histogram of those keys (``counts_from_keys_plain``).

(a) The key encoding: the decoded row maximum is ``torch.argmax`` on random
    rows and on rows with repeated maxima, +-0, -inf and NaN: a row with
    NaN names its first NaN, a row of NaN or of -inf channel 0, and every
    row counts once (the rule of ``jnp.argmax``, which kernels B and C
    keep).
(b) The stages compose bit for bit to ``fused_block_gumbel_counts_plain``
    in the bf16 and int8-static modes, f32 and bf16 planes, injected and
    Philox noise and noise with NaN and -inf rows, with R = 126 rows (not
    a multiple of the GEMM's 128-row tiles); so do the stage wrappers on
    CPU tensors, and the keys' counts equal the whole plain version's
    histogram on a plane with NaN and -inf rows.
(c) The composed stages against the JAX package's
    ``fused_block_gumbel_counts`` (Pallas in interpret mode) under the same
    injected noise: counts agreement >= 0.99, row sums = H * W, as
    tests/test_torch_port_ops.py holds the plain version.
(d) The stage wrappers take their plain versions for CPU tensors and refuse
    the dynamic int8 mode and a mis-shaped or mistyped operand before the
    kernels' library is reached.

The CUDA launches are held against these plain versions on the card by
chip_smoke.py (phase ``kernels``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_ops import _amax, _params, _prepared

from count_pipnet_tpu.ops.pallas import gumbel_head as jgh
from count_pipnet_tpu_torch.ops import fused_block as tfb
from count_pipnet_tpu_torch.ops import gumbel_head as tgh

MASK = 0xFFFFFFFF
MODES = ("bf16", "int8-static")


def _decode(keys):
    return MASK - (keys & MASK)


def _rows(case):
    """[rows, 40] f32 values of one kind of row."""
    rng = np.random.default_rng(7)
    v = torch.from_numpy(rng.normal(size=(64, 40)).astype(np.float32))
    if case == "repeated maxima":
        top = v.amax(dim=1, keepdim=True) + 1.0
        for r in range(64):  # two to four columns share the maximum
            v[r, rng.choice(40, size=2 + r % 3, replace=False)] = top[r]
    elif case == "signed zeros":
        v = torch.where(v > 0, 0.0, -0.0) - torch.where(v > 1.5, 0.0, 1e-30)
        v[:, ::3] = -v[:, ::3]  # -0 and +0 tie, and so do the tiny values
        v[0] = -0.0
        v[1] = 0.0
    elif case == "-inf":
        v[v < 0.5] = -float("inf")
        v[0] = -float("inf")  # all -inf: channel 0, as torch.argmax
        v[1, 5:] = -float("inf")
    return v


@pytest.mark.parametrize("case", ["random", "repeated maxima",
                                  "signed zeros", "-inf"])
def test_argmax_keys_decode_to_torch_argmax(case):
    v = _rows(case)
    keys = tgh.block_head_keys_plain(v, torch.zeros_like(v))
    assert keys.dtype == torch.int64 and keys.shape == (64,)
    assert torch.equal(_decode(keys), torch.argmax(v, dim=-1))
    # the noise is added before the argmax
    shift = torch.zeros_like(v)
    shift[:, 39] = 1e30
    won = _decode(tgh.block_head_keys_plain(v, shift))
    assert (won[v[:, 39] > -float("inf")] == 39).all()


def test_nan_rows_count_at_their_first_nan():
    """The JAX rule (jnp.argmax, torch.argmax): a row with NaN names its
    first NaN channel, a row of NaN channel 0, and every row counts once."""
    v = _rows("random")
    v[3] = float("nan")         # a row of NaN: channel 0
    v[4, 7] = float("nan")      # a NaN beside numbers wins
    v[5, [9, 30]] = float("nan")  # the first NaN wins
    v[6] = -float("inf")        # a row of -inf: channel 0
    v[7, 39] = float("nan")     # NaN beats +inf
    v[7, 2] = float("inf")
    keys = tgh.block_head_keys_plain(v, torch.zeros_like(v))
    assert keys.count_nonzero().item() == 64
    won = _decode(keys)
    assert won[3:8].tolist() == [0, 7, 9, 0, 39]
    assert torch.equal(won, torch.argmax(v, dim=-1))
    counts = tgh.counts_from_keys_plain(keys, 4, 16, 40)
    assert counts.shape == (4, 40) and counts.dtype == torch.float32
    assert counts.sum(dim=1).tolist() == [16.0] * 4
    assert torch.equal(counts, torch.nn.functional.one_hot(
        won.reshape(4, 16), 40).sum(dim=1).float())


def _nan_noise(b, hw, c, seed=4):
    """Injected noise [b, hw, c] with NaN and -inf rows: NaN in a few
    channels, a whole NaN row, a whole -inf row, -inf but one channel."""
    nz = torch.from_numpy(np.random.default_rng(seed).gumbel(
        size=(b, hw, c)).astype(np.float32))
    nz[0, 0, [c // 2, 5]] = float("nan")
    nz[0, 1] = float("nan")
    nz[0, 2] = -float("inf")
    nz[1, 3] = -float("inf")
    nz[1, 3, c - 1] = 0.0
    nz[1, hw - 1, c - 1] = float("nan")
    return nz


@pytest.mark.parametrize("c", [16, 64, 256])
def test_keys_count_as_the_histogram_on_nan_rows(c):
    """On one f32 block-output plane with NaN and -inf rows, the stages'
    plain versions (keys, then their counts) equal the whole plain
    version's histogram (torch.argmax) exactly."""
    b, hw = 2, 40
    res = torch.from_numpy(np.random.default_rng(c).normal(
        size=(b, hw, c)).astype(np.float32))
    nz = _nan_noise(b, hw, c)
    keys = tgh.block_head_keys_plain(res, nz)
    want = tgh._histogram(res, nz)
    assert torch.equal(tgh.counts_from_keys_plain(keys, b, hw, c), want)
    assert want.sum(dim=1).tolist() == [hw] * b
    won = _decode(keys)
    assert won[0, :3].tolist() == [5, 0, 0] and won[1, 3].item() == c - 1
    assert won[1, hw - 1].item() == c - 1


def _case(mode, c=64, hw=(7, 9), seed=0):
    tp, _ = _params(c, 30 + c)
    x4 = np.random.default_rng(seed + c).normal(size=(2, *hw, c)) \
        .astype(np.float32)
    scales = _amax(x4, tp) if mode == "int8-static" else None
    return x4, _prepared(tp, scales)


@pytest.mark.parametrize("noise", ["injected", "philox", "nan rows"])
@pytest.mark.parametrize("plane", ["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_stages_compose_to_the_plain_version(mode, plane, noise):
    x4, pb = _case(mode)
    x = torch.from_numpy(x4)
    if plane == "bf16":
        x = x.to(torch.bfloat16)
    b, h, w, c = x.shape
    nz = None
    if noise == "injected":
        nz = torch.from_numpy(np.random.default_rng(4).gumbel(
            size=(b, h * w, c)).astype(np.float32))
    elif noise == "nan rows":
        nz = _nan_noise(b, h * w, c)
    want = tgh.fused_block_gumbel_counts_plain(x, pb, seed=3, noise=nz)
    assert want.sum(dim=1).tolist() == [h * w] * b
    drawn = nz if nz is not None else tgh.gumbel_noise(3, b, h * w, c)
    keys = tgh.block_head_keys_plain(tfb.block_residual_plain(x, pb), drawn)
    assert keys.shape == (b, h, w)
    assert torch.equal(tgh.counts_from_keys_plain(keys, b, h * w, c), want)
    # the wrappers, stage by stage, take the same plain versions here
    hid = tfb.block_up(tfb.block_prologue(x, pb), pb)
    assert torch.equal(tgh.block_down_f32(hid, x, pb),
                       tfb.block_residual_plain(x, pb))
    got_keys = tgh.block_head_keys(hid, x, pb, seed=3, noise=nz)
    assert torch.equal(got_keys, keys)
    assert torch.equal(tgh.counts_from_keys(got_keys, b, h * w, c), want)
    assert torch.equal(tgh.fused_block_gumbel_counts(x, pb, seed=3,
                                                     noise=nz), want)


@pytest.mark.parametrize("mode", MODES)
def test_composed_stages_match_jax(mode):
    c, h, w = 128, 9, 9
    tp, jp = _params(c, 11, gamma=1e-2)
    x4 = np.random.default_rng(2).normal(size=(2, h, w, c)) \
        .astype(np.float32)
    noise = np.random.default_rng(4).gumbel(size=(2, h * w, c)) \
        .astype(np.float32)
    scales = _amax(x4, tp) if mode == "int8-static" else None
    want = np.asarray(jgh.fused_block_gumbel_counts(
        jnp.asarray(x4.reshape(2, h * w, c)), h, w, *jp, 0,
        int8=scales is not None, act_scales=scales,
        noise=jnp.asarray(noise), interpret=True))
    pb = _prepared(tp, scales)
    x = torch.from_numpy(x4)
    keys = tgh.block_head_keys_plain(tfb.block_residual_plain(x, pb),
                                     torch.from_numpy(noise))
    got = tgh.counts_from_keys_plain(keys, 2, h * w, c).numpy()
    np.testing.assert_array_equal(got.sum(axis=1), h * w)
    np.testing.assert_array_equal(want.sum(axis=1), h * w)
    assert np.mean(got == want) >= 0.99


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, device="meta")


def _meta_block(mode):
    _, pb = _case(mode, c=32)
    return {k: v.to("meta") if torch.is_tensor(v) else v
            for k, v in pb.items()}


_I8, _BF = torch.int8, torch.bfloat16
_BAD = {
    # what is wrong: (stage, arguments, error, message)
    "head hidden width": (
        "block_head_keys", lambda pb: (_meta(2, 3, 3, 96, dtype=_I8),
                                       _meta(2, 3, 3, 32), pb),
        ValueError, "one row of 4C"),
    "head hidden type": (
        "block_head_keys", lambda pb: (_meta(2, 3, 3, 128, dtype=_BF),
                                       _meta(2, 3, 3, 32), pb),
        TypeError, "bfloat16"),
    "head rows": (
        "block_head_keys", lambda pb: (_meta(2, 3, 4, 128, dtype=_I8),
                                       _meta(2, 3, 3, 32), pb),
        ValueError, "one row of 4C"),
    "head device": (
        "block_head_keys", lambda pb: (_meta(2, 3, 3, 128, dtype=_I8),
                                       _meta(2, 3, 3, 32), pb),
        ValueError, "unsupported device"),
    "down hidden width": (
        "block_down_f32", lambda pb: (_meta(2, 3, 3, 64, dtype=_I8),
                                      _meta(2, 3, 3, 32), pb),
        ValueError, "one row of 4C"),
    "down plane type": (
        "block_down_f32", lambda pb: (_meta(2, 3, 3, 128, dtype=_I8),
                                      _meta(2, 3, 3, 32,
                                            dtype=torch.float16), pb),
        TypeError, "float16"),
    "count key type": (
        "counts_from_keys", lambda pb: (_meta(18, dtype=torch.int32), 2, 9,
                                        32),
        ValueError, "int64"),
    "count key number": (
        "counts_from_keys", lambda pb: (_meta(17, dtype=torch.int64), 2, 9,
                                        32),
        ValueError, "18 int64"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_stage_wrappers_refuse_before_launch(case, monkeypatch):
    """A mis-shaped or mistyped operand (or one on a device that is not a
    card) raises before the kernels' library is built or called."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tgh._cuda, "library", no_library)
    stage, args, err, msg = _BAD[case]
    with pytest.raises(err, match=msg):
        getattr(tgh, stage)(*args(_meta_block("int8-static")))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("stage", ["block_head_keys", "block_down_f32",
                                   "fused_block_gumbel_counts"])
def test_stage_wrappers_refuse_the_dynamic_mode(stage, device, monkeypatch):
    """Kernel C carries the bf16 and int8-static modes; its stages refuse
    the dynamic per-row int8 mode on any device (kernel C whole takes its
    plain version for CPU tensors, which computes that mode too)."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tgh._cuda, "library", no_library)
    x4, _ = _case("bf16", c=32)
    tp, _ = _params(32, 62)
    pb = tfb.prepare_block(**{k: torch.from_numpy(v) for k, v in tp.items()},
                           int8=True)
    x = torch.from_numpy(x4)
    hid = torch.zeros(*x.shape[:-1], 128, dtype=torch.int8)
    if device == "meta":
        x, hid = x.to("meta"), hid.to("meta")
        pb = {k: v.to("meta") if torch.is_tensor(v) else v
              for k, v in pb.items()}
    if stage == "fused_block_gumbel_counts":
        if device == "cpu":
            got = tgh.fused_block_gumbel_counts(x, pb, seed=1)
            assert got.sum(dim=1).tolist() == [63.0, 63.0]
            return
        args = (x, pb)
    else:
        args = (hid, x, pb)
    with pytest.raises(ValueError, match="dynamic"):
        getattr(tgh, stage)(*args)
