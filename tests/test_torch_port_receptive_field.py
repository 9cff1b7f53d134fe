"""The port's effective receptive field (count_pipnet_tpu_torch/scripts/
receptive_field_analysis.py) against the JAX package's script
(scripts/receptive_field_analysis.py) on the same flax parameters carried
across (models/convert.py: backbone_from_jax_params): 64x64 images, 2
seeded samples, float32. The 95 %-mass sizes must be equal and the
normalised maps (maximum 1) within 1e-4 of each other.

At one stage the features end in the stem's LayerNorm, whose channel sum
has a zero gradient, so with the initial layer scales (1e-6) the map is
rounding noise in either framework. That case runs with every layer scale
at 0.1, set in the JAX script's own initialisation, so that the blocks
carry the gradient."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import count_pipnet_tpu.models as jax_models
from count_pipnet_tpu_torch.models.convert import backbone_from_jax_params
from count_pipnet_tpu_torch.scripts import receptive_field_analysis as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SAMPLES = 64, 2


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_erf",
        os.path.join(REPO, "scripts", "receptive_field_analysis.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _LayerScaled:
    """A flax ConvNeXt whose ``init`` sets every layer scale to ``value``."""

    def __init__(self, module, value):
        self.module, self.value = module, value

    def init(self, *a, **kw):
        def set_scale(path, leaf):
            last = path[-1]
            name = getattr(last, "key", getattr(last, "name", None))
            return (jnp.full_like(leaf, self.value)
                    if name == "layer_scale" else leaf)
        return jax.tree_util.tree_map_with_path(
            set_scale, self.module.init(*a, **kw))

    def apply(self, *a, **kw):
        return self.module.apply(*a, **kw)


@pytest.mark.parametrize("stages,layer_scale", [(1, 0.1), (3, None)])
def test_erf_matches_jax_script(monkeypatch, stages, layer_scale):
    make = jax_models.convnext_tiny_26_features
    if layer_scale is not None:
        monkeypatch.setattr(
            jax_models, "convnext_tiny_26_features",
            lambda **kw: _LayerScaled(make(**kw), layer_scale))
    model = jax_models.convnext_tiny_26_features(num_stages=stages)
    # the JAX script's own initialisation, carried across
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    ref, ref_size = _jax_script().effective_receptive_field(
        stages, SIZE, n_samples=SAMPLES)
    got, got_size = port.effective_receptive_field(
        stages, SIZE, n_samples=SAMPLES,
        state_dict=backbone_from_jax_params(params), device="cpu")
    assert got.shape == ref.shape == (SIZE, SIZE)
    assert got_size == ref_size
    assert np.abs(got - ref).max() <= 1e-4


def test_mass_width_and_cli(tmp_path, capsys):
    profile = np.zeros(21)
    profile[9:12] = 1.0
    assert port.mass_width(profile) == 4
    assert port.main(["--stages", "1", "--image_size", "32", "--samples",
                      "1", "--out_dir", str(tmp_path),
                      "--disable_cuda"]) == 0
    assert "stages=1: effective receptive field" in capsys.readouterr().out


def test_erf_runs_on_the_card_unless_asked(monkeypatch):
    """Called without ``device``, the function asks for the card, and
    without one it raises before it builds the model."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.effective_receptive_field(1, 32, n_samples=1)
