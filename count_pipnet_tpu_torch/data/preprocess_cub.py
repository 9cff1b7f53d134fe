"""CUB-200-2011 preprocessing: build the four ImageFolder trees.

The port's copy of count_pipnet_tpu/data/preprocess_cub.py (Pillow only).
Run it as ``python -m count_pipnet_tpu_torch.data.preprocess_cub
--cub_root ... --out_root ...``.

Reference: util/preprocess_cub.py:7-81 — reads ``images.txt``,
``train_test_split.txt`` and ``bounding_boxes.txt`` from the extracted
CUB_200_2011 archive and writes:
  dataset/train_crop  (train images cropped to the bird bounding box)
  dataset/train       (uncropped train images)
  dataset/test_crop   (test images cropped)
  dataset/test_full   (uncropped test images)
"""

import os
import shutil
from pathlib import Path

from PIL import Image

__all__ = ["preprocess_cub"]


def preprocess_cub(cub_root="./data/CUB_200_2011",
                   out_root="./data/CUB_200_2011/dataset", margin=0):
    cub_root = Path(cub_root)
    out_root = Path(out_root)

    def read_pairs(name):
        with open(cub_root / name) as f:
            return [line.strip().split() for line in f if line.strip()]

    images = {int(i): p for i, p in read_pairs("images.txt")}
    split = {int(i): int(s) for i, s in read_pairs("train_test_split.txt")}
    bboxes = {}
    with open(cub_root / "bounding_boxes.txt") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 5:
                i, x, y, w, h = parts
                bboxes[int(i)] = tuple(float(v) for v in (x, y, w, h))

    for img_id, rel_path in images.items():
        is_train = split[img_id] == 1
        cls = rel_path.split("/")[0]
        src = cub_root / "images" / rel_path
        fname = os.path.basename(rel_path)

        crop_split = "train_crop" if is_train else "test_crop"
        full_split = "train" if is_train else "test_full"

        crop_dir = out_root / crop_split / cls
        full_dir = out_root / full_split / cls
        crop_dir.mkdir(parents=True, exist_ok=True)
        full_dir.mkdir(parents=True, exist_ok=True)

        shutil.copy2(src, full_dir / fname)

        x, y, w, h = bboxes[img_id]
        with Image.open(src) as im:
            im = im.convert("RGB")
            box = (max(0, x - margin), max(0, y - margin),
                   min(im.width, x + w + margin),
                   min(im.height, y + h + margin))
            im.crop(box).save(crop_dir / fname)

    print(f"CUB dataset trees written under {out_root}")


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser("Preprocess CUB-200-2011")
    p.add_argument("--cub_root", default="./data/CUB_200_2011")
    p.add_argument("--out_root", default="./data/CUB_200_2011/dataset")
    a = p.parse_args()
    preprocess_cub(a.cub_root, a.out_root)
