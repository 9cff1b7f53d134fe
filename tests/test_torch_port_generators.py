"""The port's dataset generators (count_pipnet_tpu_torch/data/) against
the JAX package's: for the same flags and seed, byte-identical files
(shapes, shapes with ``--flagship200`` and with background noise, digits;
``preprocess_cub`` on a three-image CUB-layout tree made here), the same
regeneration table, and ``validate_dataset_paths`` regenerating a missing
synthetic dataset with the port's generator. Tiny sizes."""

import argparse
import hashlib

import numpy as np
import pytest
from PIL import Image

from count_pipnet_tpu.data import ensure as jensure
from count_pipnet_tpu.data import generate_digits as jdigits
from count_pipnet_tpu.data import generate_shapes as jshapes
from count_pipnet_tpu.data.preprocess_cub import preprocess_cub as jcub
from count_pipnet_tpu_torch.data import ensure, generate_digits, \
    generate_shapes
from count_pipnet_tpu_torch.data.preprocess_cub import preprocess_cub
from count_pipnet_tpu_torch.data.registry import validate_dataset_paths


def _digests(root):
    """{relative path: sha256} of every file under ``root``."""
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("module,jmodule,flags,n_files", [
    (generate_shapes, jshapes, ["--img_size", "48"], 27),
    (generate_shapes, jshapes, ["--img_size", "48", "--noise_level", "40",
                                "--seed", "5"], 27),
    (generate_shapes, jshapes, ["--img_size", "48", "--flagship200",
                                "--test_samples_per_class", "0"], 400),
    (generate_digits, jdigits, ["--img_size", "48"], 12),
], ids=["shapes", "shapes_noise", "shapes_flagship200", "digits"])
def test_generator_bytes_match_jax(tmp_path, module, jmodule, flags,
                                   n_files):
    argv = ["--train_samples_per_class", "2", "--test_samples_per_class",
            "1", *flags]
    module.main(["--output_dir", str(tmp_path / "port"), *argv])
    jmodule.main(["--output_dir", str(tmp_path / "jax"), *argv])
    ours = _digests(tmp_path / "port")
    assert len(ours) == n_files
    assert ours == _digests(tmp_path / "jax")


def test_preprocess_cub_matches_jax(tmp_path):
    """Three images of two classes (two train, one test) with bounding
    boxes: the four ImageFolder trees, file for file."""
    cub = tmp_path / "CUB_200_2011"
    rng = np.random.default_rng(0)
    rows = [(1, "001.Black_footed_Albatross/a_1.jpg", 1, (3, 4, 20, 16)),
            (2, "001.Black_footed_Albatross/a_2.jpg", 0, (0, 0, 40, 30)),
            (3, "002.Laysan_Albatross/b_1.jpg", 1, (10.5, 2.0, 25.0, 27.5))]
    for _, rel, _, _ in rows:
        path = cub / "images" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
                        ).save(path, quality=90)
    (cub / "images.txt").write_text(
        "".join(f"{i} {rel}\n" for i, rel, _, _ in rows))
    (cub / "train_test_split.txt").write_text(
        "".join(f"{i} {s}\n" for i, _, s, _ in rows))
    (cub / "bounding_boxes.txt").write_text(
        "".join(f"{i} {' '.join(map(str, b))}\n" for i, _, _, b in rows))
    preprocess_cub(cub, tmp_path / "port")
    jcub(cub, tmp_path / "jax")
    ours = _digests(tmp_path / "port")
    assert sorted({k.split("/")[0] for k in ours}) == [
        "test_crop", "test_full", "train", "train_crop"]
    assert len(ours) == 6
    assert ours == _digests(tmp_path / "jax")


def test_regeneration_table_matches_jax():
    assert ensure.SYNTHETIC_GENERATORS == jensure.SYNTHETIC_GENERATORS


def test_validate_dataset_paths_regenerates(tmp_path, monkeypatch, capsys):
    """A missing synthetic dataset is regenerated by the port's generator
    (here at a tiny size) before the paths are checked; a dataset that
    cannot be made from a seed still raises with the port's hint."""
    monkeypatch.setitem(ensure.SYNTHETIC_GENERATORS, "geometric_shapes", [
        ("shapes", ["--output_dir", "data/geometric_shapes/dataset",
                    "--img_size", "48", "--train_samples_per_class", "1",
                    "--test_samples_per_class", "1"])])
    validate_dataset_paths(argparse.Namespace(dataset="geometric_shapes"),
                           basepath=str(tmp_path))
    assert "regenerating" in capsys.readouterr().out
    data = tmp_path / "data" / "geometric_shapes" / "dataset"
    assert len(list((data / "train").rglob("*.png"))) == 9
    with pytest.raises(FileNotFoundError,
                       match="count_pipnet_tpu_torch.data.generate_shapes"):
        validate_dataset_paths(argparse.Namespace(dataset="CUB-200-2011"),
                               basepath=str(tmp_path))
