"""The port's CUB part-purity evaluation (count_pipnet_tpu_torch/
interpret/eval_cub_csv.py):

* the cases of tests/test_eval_cub.py on the port's module: synthetic CUB
  annotation files (images.txt, part_locs.txt, parts.txt) and a patch CSV
  of known geometry, so the purities are exact, and the center crop of an
  oversized patch;
* ``get_topk_cub`` and ``get_proto_patches_cub`` write the JAX package's
  rows on the same PIP-Net (a JAX run, tests/
  test_torch_port_interpret_idg.py) and projection set (softmax maps,
  so every argmax patch is unique and the rows compare exactly)."""

import csv
import os
import types

import pytest
from PIL import Image

from count_pipnet_tpu.interpret import eval_cub_csv as jcub
from count_pipnet_tpu.interpret import interpret_idg as jidg
from count_pipnet_tpu_torch.data.datasets import (ImageFolder,
                                                  TransformedDataset)
from count_pipnet_tpu_torch.data.loader import DataLoader
from count_pipnet_tpu_torch.data.registry import _no_augment
from count_pipnet_tpu_torch.interpret import interpret_idg as tidg
from count_pipnet_tpu_torch.interpret.eval_cub_csv import (
    CSV_COLUMNS, eval_prototypes_cub_parts_csv, get_proto_patches_cub,
    get_topk_cub)
from test_torch_port_interpret_idg import (  # noqa: F401
    LAT, SIDE, make_dataset, make_jax_run, two_threads)


class Args:
    image_size = 64
    wshape = 8


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_part_purity_exact(tmp_path):
    img_dir = tmp_path / "imgs" / "001.Species"
    os.makedirs(img_dir)
    img_paths = []
    for i in range(4):
        p = img_dir / f"bird_{i}.jpg"
        Image.new("RGB", (128, 128), (i * 10, 0, 0)).save(p)
        img_paths.append(str(p))
    _write(tmp_path / "images.txt",
           [f"{i + 1} 001.Species/bird_{i}.jpg" for i in range(4)])
    # one visible beak (id 1) and one left wing (id 2) per image, in
    # original-image coordinates
    _write(tmp_path / "parts.txt",
           ["1 beak", "2 left wing", "3 right wing"])
    _write(tmp_path / "part_locs.txt",
           [f"{i + 1} 1 64.0 64.0 1" for i in range(4)]
           + [f"{i + 1} 2 10.0 10.0 1" for i in range(4)])
    # prototype 0 covers the center (the beak), prototype 1 the corner
    # (the left wing, merged into the right wing)
    csvfile = tmp_path / "patches.csv"
    with open(csvfile, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(CSV_COLUMNS)
        for i in range(4):
            wr.writerow([0, img_paths[i], 16, 48, 16, 48])
            wr.writerow([1, img_paths[i], 0, 12, 0, 12])
    res = eval_prototypes_cub_parts_csv(
        str(csvfile), str(tmp_path / "part_locs.txt"),
        str(tmp_path / "parts.txt"), str(tmp_path / "images.txt"),
        epoch=1, args=Args, log=None)
    assert res["part_related"] == 2
    assert res["max_purity_part"]["0"] == "beak"
    assert res["max_purity_part"]["1"] == "right wing"
    assert abs(res["mean_purity"] - 1.0) < 1e-9


def test_patch_center_crop_shrinks_oversized(tmp_path):
    """A part point inside the raw box but outside the box cropped to the
    patch size (32 at wshape 8, image 64) does not count."""
    img_dir = tmp_path / "i" / "001.S"
    os.makedirs(img_dir)
    p = img_dir / "bird_0.jpg"
    Image.new("RGB", (64, 64)).save(p)
    _write(tmp_path / "images.txt", ["1 001.S/bird_0.jpg"])
    _write(tmp_path / "parts.txt", ["1 beak"])
    _write(tmp_path / "part_locs.txt", ["1 1 2.0 2.0 1"])
    csvfile = tmp_path / "c.csv"
    with open(csvfile, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(CSV_COLUMNS)
        wr.writerow([0, str(p), 0, 64, 0, 64])
    res = eval_prototypes_cub_parts_csv(
        str(csvfile), str(tmp_path / "part_locs.txt"),
        str(tmp_path / "parts.txt"), str(tmp_path / "images.txt"),
        epoch=1, args=Args, log=None)
    assert res["part_related"] == 0
    assert res["mean_purity"] == 0.0


@pytest.fixture(scope="module")
def pipnet_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cub")
    make_dataset(root)
    run = str(make_jax_run(root, "pipnet")[0])
    ds = TransformedDataset(
        ImageFolder(root / "data/geometric_shapes/dataset/train"),
        _no_augment(SIDE))
    return root, run, DataLoader(ds, 1, shuffle=False, num_workers=1)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("what", ["topk", "all"])
def test_patch_csvs_match_jax(pipnet_run, what):
    root, run, loader = pipnet_run
    jmodel, jparams, _, _ = jidg.load_model_for_interpretation(run)
    model, _ = tidg.load_model_for_interpretation(run, device="cpu")
    rows = {}
    for side, mod, trainer in (
            ("jax", jcub, types.SimpleNamespace(
                model=jmodel, params=jparams, batch_stats={}, tau=1.0)),
            ("port", None, types.SimpleNamespace(model=model, tau=1.0,
                                                 dtype="float32"))):
        args = types.SimpleNamespace(log_dir=str(root / side),
                                     image_size=SIDE, wshape=LAT)
        os.makedirs(args.log_dir, exist_ok=True)
        if what == "topk":
            fn = jcub.get_topk_cub if mod else get_topk_cub
            path = fn(trainer, loader, 5, "best", args)
        else:
            fn = jcub.get_proto_patches_cub if mod else get_proto_patches_cub
            path = fn(trainer, loader, "best", args, threshold=0.3)
        assert os.path.basename(path) == (
            f"best_pipnet_prototypes_cub_{what}.csv")
        rows[side] = _rows(path)
    assert rows["port"][0] == CSV_COLUMNS
    assert len(rows["jax"]) > 1 and rows["port"] == rows["jax"]
