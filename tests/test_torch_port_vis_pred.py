"""The port's prediction explanations (count_pipnet_tpu_torch/interpret/
visualize_prediction.py: ``vis_pred`` and ``vis_pred_experiments``)
against the JAX package's on the same trained run (a gumbel Count-PIPNet
and a PIP-Net written by the JAX package, tests/
test_torch_port_interpret_idg.py), the same test images and the same
injected Gumbel noise. The file names print values to 3 decimals, and a
value within 5e-4 of a rounding edge may print differently: the trees
hold the same (image, class rank, class, prototype, file kind) entries,
and every number in the names agrees within 1e-3."""

import re
import types

import numpy as np
import pytest

from count_pipnet_tpu.interpret import interpret_idg as jidg
from count_pipnet_tpu.interpret import visualize_prediction as jvp
from count_pipnet_tpu_torch.interpret import interpret_idg as tidg
from count_pipnet_tpu_torch.interpret import visualize_prediction as tvp
from test_torch_port_interpret_idg import (  # noqa: F401
    SIDE, inject_noise, make_dataset, make_jax_run, two_threads)

NAME = re.compile(r"(?P<img>[^/]+)/(?P<rank>\d+)_(?P<cls>.+)_output"
                  r"(?P<out>-?[\d.]+)/mul(?P<mul>-?[\d.]+)_p(?P<p>\d+)_sim"
                  r"(?P<sim>-?[\d.]+)_w(?P<w>-?[\d.]+)_(?P<kind>\w+)\.png")


def _entries(root):
    """{(image, rank, class, prototype, kind): (output, mul, sim, w)}."""
    out = {}
    for path in root.rglob("*.png"):
        m = NAME.fullmatch(path.relative_to(root).as_posix())
        assert m, path
        key = (m["img"], int(m["rank"]), m["cls"], int(m["p"]), m["kind"])
        out[key] = tuple(float(m[k]) for k in ("out", "mul", "sim", "w"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("vis_pred")
    make_dataset(root)
    return root, {k: make_jax_run(root, k) for k in ("count", "pipnet")}


@pytest.mark.parametrize("kind", ["count", "pipnet"])
@pytest.mark.parametrize("entry", ["vis_pred", "vis_pred_experiments"])
def test_vis_pred_matches_jax(monkeypatch, runs, kind, entry):
    inject_noise(monkeypatch)
    root, by_kind = runs
    run = str(by_kind[kind][0])
    jmodel, jparams, _, _ = jidg.load_model_for_interpretation(run)
    model, _ = tidg.load_model_for_interpretation(run, device="cpu")
    test_dir = root / "data/geometric_shapes/dataset/test"
    classes = sorted(p.name for p in test_dir.iterdir())
    trees = {}
    for side, mod, trainer in (
            ("jax", jvp, types.SimpleNamespace(
                model=jmodel, params=jparams, batch_stats={}, tau=1.0)),
            ("port", tvp, types.SimpleNamespace(model=model, tau=1.0,
                                                dtype="float32"))):
        args = types.SimpleNamespace(log_dir=str(root / f"{entry}_{kind}"),
                                     dir_for_saving_images=side,
                                     image_size=SIDE)
        if entry == "vis_pred":
            mod.vis_pred(trainer, str(test_dir), classes, args,
                         n_per_class=1)
            trees[side] = _entries(root / f"{entry}_{kind}" / side)
        else:
            mod.vis_pred_experiments(trainer, str(test_dir / classes[0]),
                                     classes, args)
            trees[side] = _entries(root / f"{entry}_{kind}" /
                                   f"{side}_experiments")
    want, got = trees["jax"], trees["port"]
    assert want and got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3,
                                   err_msg=str(key))
