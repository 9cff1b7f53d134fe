"""The port's pretrained-checkpoint validation kit (count_pipnet_tpu_torch/
scripts/validate_pretrained.py) on synthetic state dicts: torchvision's
convnext_tiny naming (test_torch_golden.py: synth_sd) truncated at 3
stages, and a ResNet-18 (test_weight_convert.py:
synth_resnet18_state_dict), both at 32x32 on the CPU. The kit passes on
both; a dropped tensor is caught by the accounting; a same-shape
permutation in the loading path is caught by the independent forward
alone; and the goldens .npz equals the JAX kit's (scripts/
validate_pretrained.py: its --save-goldens keys and input, and its
forward of the same state dict) within 1e-4 relative."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from count_pipnet_tpu.models import resnet as jr
from count_pipnet_tpu.models.convnext import (
    convert_torchvision_convnext, convnext_tiny_26_features as jax_convnext)
from count_pipnet_tpu_torch.scripts import validate_pretrained as V
from test_torch_golden import synth_sd
from test_weight_convert import synth_resnet18_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, STAGES = 32, 3


def _convnext_sd():
    return synth_sd(np.random.default_rng(0))


def _resnet_sd():
    """Convs scaled by 1/sqrt(fan in), so that the features stay O(1)."""
    sd = {}
    for k, v in synth_resnet18_state_dict(np.random.default_rng(1)).items():
        if v.ndim == 4:
            v = v / np.sqrt(np.prod(v.shape[1:]))
        sd[k] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return sd


def _jax_kit():
    spec = importlib.util.spec_from_file_location(
        "_jax_vp", os.path.join(REPO, "scripts", "validate_pretrained.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_features(arch, sd, x):
    """The JAX kit's forward of ``sd`` on ``x`` (its functions, called as
    test_weight_convert.py's TestValidationKitChecks calls them)."""
    if arch == "convnext_tiny":
        params = convert_torchvision_convnext(sd, num_stages=STAGES)
        return _jax_kit().forward_ours(
            jax_convnext(num_stages=STAGES), params, None, x)
    params, stats = jr.convert_torch_resnet(sd, (2, 2, 2, 2),
                                            bottleneck=False)
    return _jax_kit().forward_ours(
        jr.ResNetFeatures(jr.BasicBlock, (2, 2, 2, 2)), params, stats, x)


@pytest.mark.parametrize("arch,make_sd", [("convnext_tiny", _convnext_sd),
                                          ("resnet18", _resnet_sd)])
def test_kit_passes_and_goldens_match_jax(tmp_path, capsys, arch, make_sd):
    ckpt = tmp_path / "ckpt.pth"
    sd = make_sd()
    torch.save(sd, ckpt)
    common = ["--checkpoint", str(ckpt), "--arch", arch, "--num_stages",
              str(STAGES), "--image_size", str(SIZE)]
    ours = tmp_path / "port.npz"
    assert V.main([*common, "--save-goldens", str(ours),
                   "--disable_cuda"]) == 0
    out = capsys.readouterr().out
    assert "structural check vs fresh module: OK" in out
    assert "sentinel round-trip" in out and "FAILED" not in out
    assert "torch-parity SKIPPED" in out or "forward parity" in out
    a = np.load(ours)
    # the JAX kit's --save-goldens keys and input (its main)
    assert sorted(a.files) == ["arch", "features", "input", "num_stages"]
    x = np.random.default_rng(0).normal(
        size=(1, SIZE, SIZE, 3)).astype(np.float32)
    np.testing.assert_array_equal(a["input"], x)
    assert str(a["arch"]) == arch and int(a["num_stages"]) == STAGES
    fb = _jax_features(arch, sd, x)
    fa = a["features"]
    assert fa.shape == fb.shape
    assert np.abs(fa - fb).max() <= 1e-4 * np.abs(fb).max()


@pytest.mark.parametrize("arch,make_sd,key", [
    ("convnext_tiny", _convnext_sd, "features.3.1.block.3.bias"),
    ("resnet18", _resnet_sd, "layer2.0.bn1.running_var")])
def test_dropped_tensor_is_caught(capsys, arch, make_sd, key):
    sd = make_sd()
    del sd[key]
    assert not V.validate(sd, arch, STAGES, image_size=SIZE, device="cpu")
    assert f"missing converted tensor: {key}" in capsys.readouterr().out


def test_permutation_is_caught_by_the_independent_forward(capsys):
    sd = _convnext_sd()
    a, b = "features.1.0.block.0.weight", "features.1.1.block.0.weight"

    def miswired(s):
        out = V.convert_convnext(s, STAGES)
        out[a], out[b] = out[b], out[a]
        return out

    assert not V.validate(sd, "convnext_tiny", STAGES, image_size=SIZE,
                          device="cpu", convert=miswired)
    out = capsys.readouterr().out
    # the accounting cannot see it; the independent forward does
    assert "sentinel round-trip" in out and "): OK" in out
    assert "structural check vs fresh module: OK" in out
    assert "MISWIRED" in out


@pytest.mark.parametrize("call", [
    lambda: V.validate({}, "convnext_tiny", STAGES, image_size=SIZE),
    lambda: V.forward_ours(None, {},
                           np.zeros((1, SIZE, SIZE, 3), np.float32)),
    lambda: V.forward_from_sd_convnext(
        {}, np.zeros((1, SIZE, SIZE, 3), np.float32), STAGES),
], ids=["validate", "forward_ours", "forward_from_sd_convnext"])
def test_forwards_run_on_the_card_unless_asked(monkeypatch, call):
    """Called without ``device``, the kit asks for the card, and without
    one it raises before it computes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
