"""The port's augmentation sheet (count_pipnet_tpu_torch/scripts/
visualize_augmented_samples.py) against the JAX package's script
(scripts/visualize_augmented_samples.py) on one tiny geometric_shapes set
made by the port's generator with a fixed seed: the two PNGs must be
equal pixel for pixel. The port's host augmentation (data/augment.py) is
a copy of the JAX package's and draws from the same random.Random
streams, so no draw differs by design; the originals column is held
equal on its own as well, so that a difference in the views is told
apart from one in the data."""

import importlib.util
import os
import sys

import numpy as np
import pytest
from PIL import Image

from count_pipnet_tpu_torch.data.generate_shapes import \
    GeometricShapesGenerator
from count_pipnet_tpu_torch.scripts import visualize_augmented_samples as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, N = 32, 3


@pytest.fixture(scope="module")
def shapes_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug_sheet")
    GeometricShapesGenerator({
        "output_dir": str(root / "data/geometric_shapes/dataset"),
        "img_size": 64, "train_samples_per_class": 3,
        "test_samples_per_class": 1, "seed": 0,
        "class_definitions": [("circle", 1), ("triangle", 2)],
        "size_mean": 12, "size_std": 2, "min_object_size": 8,
        "max_object_size": 16,
    }).generate_dataset()
    return root


def _jax_main(argv):
    spec = importlib.util.spec_from_file_location(
        "_jax_aug", os.path.join(REPO, "scripts",
                                 "visualize_augmented_samples.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["visualize_augmented_samples.py", *argv]
    try:
        mod.main()
    finally:
        sys.argv = old


@pytest.mark.parametrize("seed", [0, 3])
def test_sheet_matches_jax_script(shapes_root, tmp_path, seed):
    common = ["--dataset", "geometric_shapes", "--image_size", str(SIZE),
              "--basepath", str(shapes_root), "--n", str(N),
              "--seed", str(seed)]
    ref_png, got_png = tmp_path / "jax.png", tmp_path / "port.png"
    _jax_main([*common, "--out", str(ref_png)])
    assert port.main([*common, "--out", str(got_png)]) == 0
    ref = np.asarray(Image.open(ref_png).convert("RGB"))
    got = np.asarray(Image.open(got_png).convert("RGB"))
    assert got.shape == ref.shape == (N * port.CELL, 3 * port.CELL, 3)
    cell = port.CELL
    np.testing.assert_array_equal(got[:, :cell], ref[:, :cell])
    np.testing.assert_array_equal(got, ref)
    # the two views are augmented draws, not copies of the original
    assert not np.array_equal(got[:, cell:2 * cell], got[:, :cell])
