"""CUB part-purity evaluation via prototype patch-coordinate CSVs.

Port of count_pipnet_tpu/interpret/eval_cub_csv.py (reference
util/eval_cub_csv.py) — three capabilities:
* ``get_proto_patches_cub``: CSV of every patch above a similarity
  threshold per prototype (:178-216);
* ``get_topk_cub``: CSV of top-k patches per prototype (:218-283);
* ``eval_prototypes_cub_parts_csv``: intersect patch boxes with CUB part
  annotations (left/right parts merged), compute per-prototype part
  purity and #part-related prototypes (purity > 0.5), append results to
  the run CSV (:16-176).

The projection set is scored once, in batches on the model's device
(vis_pipnet.score_projection_set, in the trainer's dtype); the CSV
schema is unchanged:
  prototype, img name, h_min_224, h_max_224, w_min_224, w_max_224
"""

import csv
import os
from typing import Dict

import numpy as np

from ..utils.func import get_patch_size
from .vis_pipnet import (_dataset_paths, _importance, get_img_coordinates,
                         score_projection_set)

__all__ = ["get_proto_patches_cub", "get_topk_cub",
           "eval_prototypes_cub_parts_csv"]

CSV_COLUMNS = ["prototype", "img name", "h_min_224", "h_max_224",
               "w_min_224", "w_max_224"]


def _relevant_prototypes(model, threshold=1e-5):
    return np.where(_importance(model) > threshold)[0]


def _scored(trainer, projectloader):
    model = trainer.model
    stats = score_projection_set(model, projectloader,
                                 tau=getattr(trainer, "tau", 1.0),
                                 dtype=getattr(trainer, "dtype", "float32"))
    return model, stats, _dataset_paths(projectloader)


def _patch_box(args, stats, latent_hw, i, p):
    patchsize, skip = get_patch_size(args.image_size, latent_hw[1])
    shape = (0,) + latent_hw
    return get_img_coordinates(
        args.image_size, shape, patchsize, skip,
        int(stats["h_idx"][i, p]), int(stats["w_idx"][i, p]))


def get_proto_patches_cub(trainer, projectloader, epoch, args,
                          threshold=0.5):
    """All patches above similarity threshold -> CSV
    (reference eval_cub_csv.py:178-216)."""
    model, stats, paths = _scored(trainer, projectloader)
    wshape = getattr(args, "wshape", int(stats["w_idx"].max()) + 1)
    latent_hw = (wshape, wshape)
    keep = _relevant_prototypes(model)

    csvfilepath = os.path.join(
        args.log_dir, f"{epoch}_pipnet_prototypes_cub_all.csv")
    with open(csvfilepath, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(CSV_COLUMNS)
        rows = []
        for i in range(stats["pooled"].shape[0]):
            for p in keep:
                if stats["pooled"][i, p] > threshold:
                    h0, h1, w0, w1 = _patch_box(args, stats, latent_hw, i, p)
                    rows.append([int(p), paths[i], h0, h1, w0, w1])
        writer.writerows(rows)
    return csvfilepath


def get_topk_cub(trainer, projectloader, k, epoch, args):
    """Top-k patches per prototype -> CSV
    (reference eval_cub_csv.py:218-283)."""
    model, stats, paths = _scored(trainer, projectloader)
    wshape = getattr(args, "wshape", int(stats["w_idx"].max()) + 1)
    latent_hw = (wshape, wshape)
    keep = _relevant_prototypes(model)

    csvfilepath = os.path.join(
        args.log_dir, f"{epoch}_pipnet_prototypes_cub_topk.csv")
    too_small = set()
    with open(csvfilepath, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(CSV_COLUMNS)
        rows = []
        for p in keep:
            scores = stats["pooled"][:, p]
            order = np.argsort(-scores)[:k]
            for i in order:
                if scores[i] < 0.1:
                    too_small.add(int(p))
                h0, h1, w0, w1 = _patch_box(args, stats, latent_hw,
                                            int(i), p)
                rows.append([int(p), paths[int(i)], h0, h1, w0, w1])
        if too_small:
            print("Warning: top-k includes patches with similarity < 0.1 "
                  "for prototypes", sorted(too_small),
                  "- consider reducing k", flush=True)
        writer.writerows(rows)
    return csvfilepath


def eval_prototypes_cub_parts_csv(csvfile, parts_loc_path, parts_name_path,
                                  imgs_id_path, epoch, args, log):
    """Part purity from a patch CSV + CUB part annotations
    (reference eval_cub_csv.py:16-176)."""
    patchsize, _ = get_patch_size(args.image_size,
                                  getattr(args, "wshape", 26))
    imgresize = float(args.image_size)

    path_to_id = {}
    with open(imgs_id_path) as f:
        for line in f:
            img_id, path = line.strip().split(" ", 1)
            path_to_id[path] = img_id

    img_part_xy: Dict[str, Dict[str, tuple]] = {}
    with open(parts_loc_path) as f:
        for line in f:
            img, partid, x, y, vis = line.strip().split(" ")
            if vis == "1":
                img_part_xy.setdefault(img, {})[partid] = (float(x),
                                                           float(y))

    parts_id_to_name, parts_name_to_id = {}, {}
    with open(parts_name_path) as f:
        for line in f:
            pid, name = line.strip().split(" ", 1)
            parts_id_to_name[pid] = name
            parts_name_to_id[name] = pid
    # merge left parts into their right counterparts
    left_to_right = {}
    for name, pid in parts_name_to_id.items():
        if "left" in name:
            left_to_right[pid] = parts_name_to_id[name.replace("left",
                                                               "right")]

    from PIL import Image
    presences: Dict[str, Dict[str, list]] = {}
    with open(csvfile, newline="") as f:
        reader = csv.reader(f)
        next(reader)
        for proto, imgname, h0, h1, w0, w1 in reader:
            presences.setdefault(proto, {})
            imgname_norm = imgname.replace("\\", "/")
            cls, fname = imgname_norm.split("/")[-2:]
            if "normal_" in fname:
                fname = fname.split("normal_")[-1]
            img_id = path_to_id[f"{cls}/{fname}"]
            with Image.open(imgname) as im:
                ow, oh = im.size
            h0, h1, w0, w1 = (float(v) for v in (h0, h1, w0, w1))
            # center-crop oversized patches so patch size doesn't inflate
            # purity (reference :78-88)
            if h1 - h0 > patchsize:
                corr = (h1 - h0) - patchsize
                h0 += corr // 2.0
                h1 -= corr // 2.0
            if w1 - w0 > patchsize:
                corr = (w1 - w0) - patchsize
                w0 += corr // 2.0
                w1 -= corr // 2.0
            oh0, oh1 = (oh / imgresize) * h0, (oh / imgresize) * h1
            ow0, ow1 = (ow / imgresize) * w0, (ow / imgresize) * w1

            parts_here = img_part_xy.get(img_id, {})
            row_presence = {}
            for part, (x, y) in parts_here.items():
                inside = int(oh0 <= y <= oh1 and ow0 <= x <= ow1)
                row_presence[part] = inside
            # merge left/right before accumulating
            merged = {}
            for part, val in row_presence.items():
                target = left_to_right.get(part, part)
                merged[target] = max(merged.get(target, 0), val)
            for part, val in merged.items():
                presences[proto].setdefault(part, []).append(val)

    print("\n Eval CUB Parts - Epoch:", epoch, flush=True)
    print("Number of prototypes in parts_presences:", len(presences),
          flush=True)

    part_related = 0
    max_purity, max_purity_part = {}, {}
    most_often_purity = {}
    for proto, parts in presences.items():
        best_purity, best_part, best_sum = 0.0, None, -1
        most_part, most_sum, most_p = None, -1, 0.0
        for part, vals in parts.items():
            purity = float(np.mean(vals))
            s = int(np.sum(vals))
            if purity > best_purity or (purity == best_purity
                                        and s > best_sum):
                best_purity, best_part, best_sum = purity, part, s
            if s > most_sum:
                most_part, most_sum, most_p = part, s, purity
        max_purity[proto] = best_purity
        max_purity_part[proto] = parts_id_to_name.get(best_part, best_part)
        most_often_purity[proto] = most_p
        if best_purity > 0.5:
            part_related += 1

    mean_p = float(np.mean(list(max_purity.values()))) if max_purity else 0.0
    std_p = float(np.std(list(max_purity.values()))) if max_purity else 0.0
    mean_mo = float(np.mean(list(most_often_purity.values()))) \
        if most_often_purity else 0.0
    std_mo = float(np.std(list(most_often_purity.values()))) \
        if most_often_purity else 0.0
    print("Number of part-related prototypes (purity>0.5):", part_related,
          flush=True)
    print("Mean purity of prototypes:", mean_p, "std:", std_p, flush=True)

    if log is not None:
        log.log_values(
            "log_epoch_overview", f"p_cub_{epoch}", mean_p, std_p, mean_mo,
            std_mo, len(presences), part_related, "", "", "", "", "", "",
            "", "")
    return {"mean_purity": mean_p, "std_purity": std_p,
            "part_related": part_related,
            "max_purity_part": max_purity_part}
