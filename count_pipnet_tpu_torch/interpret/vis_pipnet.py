"""Prototype visualization: top-k patch projection and rendering.

Port of count_pipnet_tpu/interpret/vis_pipnet.py (reference
util/vis_pipnet.py: the ``vizualize_network`` dispatcher :30-66, the
PIP-Net variant :68-497, the Count variant :499-1043,
``get_img_coordinates`` :1162-1193).

The projection set is scored in batches on the model's device under
``torch.no_grad()`` (``score_projection_set``: pooled scores and each
prototype's argmax patch per image come back in one pass); the top-k
bookkeeping (``select_topk``), patch cropping and grid rendering run on
the host. Pillow and matplotlib are imported where an image is touched,
so scoring and selection run without them.

Artifacts (the reference's tree, README.md:52-65):
  <log_dir>/<foldername>/prototype_<p>/p<p>_<rank>_sim<score>.png
  <log_dir>/<foldername>/grid_topk_<p>.png
  <log_dir>/<foldername>/grid_topk_all.png
  <log_dir>/<foldername>/feature_maps/prototype_<p>/...  (prototype maps)
  (count variant: patches grouped and labelled by count value)
"""

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.pipnet import CountPIPNet, importance_per_class
from ..train.steps import autocast_for
from ..utils.func import get_patch_size

__all__ = ["vizualize_network", "visualize_all_patches",
           "get_img_coordinates", "score_projection_set", "score_batch",
           "select_topk"]


def get_img_coordinates(img_size, softmaxes_shape, patchsize, skip, h_idx,
                        w_idx):
    """Latent (h, w) -> pixel patch box, with the reference's special-case
    edge handling for 26x26 latents (util/vis_pipnet.py:1162-1193).

    softmaxes_shape is (num_prototypes, H, W) like the reference's CHW
    convention.
    """
    if softmaxes_shape[1] == 26 and softmaxes_shape[2] == 26:
        h_coor_min = max(0, (h_idx - 1) * skip + 4)
        if h_idx < softmaxes_shape[-1] - 1:
            h_coor_max = h_coor_min + patchsize
        else:
            h_coor_min -= 4
            h_coor_max = h_coor_min + patchsize
        w_coor_min = max(0, (w_idx - 1) * skip + 4)
        if w_idx < softmaxes_shape[-1] - 1:
            w_coor_max = w_coor_min + patchsize
        else:
            w_coor_min -= 4
            w_coor_max = w_coor_min + patchsize
    else:
        h_coor_min = h_idx * skip
        h_coor_max = min(img_size, h_idx * skip + patchsize)
        w_coor_min = w_idx * skip
        w_coor_max = min(img_size, w_idx * skip + patchsize)

    if h_idx == softmaxes_shape[1] - 1:
        h_coor_max = img_size
    if w_idx == softmaxes_shape[2] - 1:
        w_coor_max = img_size
    if h_coor_max == img_size:
        h_coor_min = img_size - patchsize
    if w_coor_max == img_size:
        w_coor_min = img_size - patchsize
    return h_coor_min, h_coor_max, w_coor_min, w_coor_max


def _model_device(model):
    return next(model.parameters()).device


@torch.no_grad()
def _inference(model, xs, *, tau, generator, dtype):
    """The model's inference forward -> (f32 prototype maps [B, H, W, P],
    f32 pooled [B, P])."""
    with autocast_for(xs.device, dtype):
        proto, pooled, _ = model(xs, inference=True, train=False, tau=tau,
                                 generator=generator)
    return proto.float(), pooled.float()


def score_batch(model, xs, *, tau=1.0, generator=None, dtype="float32"):
    """One batch of normalized images [B, H, W, 3] on the model's device ->
    (pooled, max patch activation, argmax patch row, argmax patch column),
    each [B, P]; the first maximal patch wins a tie, as with
    ``jnp.argmax``."""
    proto, pooled = _inference(model, xs, tau=tau, generator=generator,
                               dtype=dtype)
    b, h, w, p = proto.shape
    flat = proto.reshape(b, h * w, p)
    argmax = flat.argmax(dim=1)
    return pooled, flat.amax(dim=1), argmax // w, argmax % w


def score_projection_set(model, projectloader, *, tau=1.0, batch=64,
                         generator=None, dtype="float32"):
    """Score every projection image in batches of ``batch`` on the model's
    device. ``generator`` draws the Gumbel noise of a Count-PIPNet (a
    fresh one seeded 0 when None); ``dtype`` "bfloat16" runs the forward
    under autocast, as the trainer does.

    Returns dict of numpy arrays: pooled [N,P], max_act [N,P], h_idx [N,P],
    w_idx [N,P], ys [N].
    """
    device = _model_device(model)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    xs_buf, ys_buf = [], []
    outs = {"pooled": [], "max_act": [], "h_idx": [], "w_idx": []}

    def flush():
        if not xs_buf:
            return
        xs = torch.stack(xs_buf).to(device)
        for key, v in zip(outs, score_batch(model, xs, tau=tau,
                                            generator=generator,
                                            dtype=dtype)):
            outs[key].append(v.cpu().numpy())
        xs_buf.clear()

    for xs, ys in projectloader:
        ys_buf.extend(torch.as_tensor(ys).tolist())
        for i in range(xs.shape[0]):
            xs_buf.append(torch.as_tensor(xs[i], dtype=torch.float32))
            if len(xs_buf) == batch:
                flush()
    flush()

    if not outs["pooled"]:
        empty = np.zeros((0, model.num_prototypes))
        return {"pooled": empty, "max_act": empty, "h_idx": empty,
                "w_idx": empty, "ys": np.asarray(ys_buf, np.int64)}
    out = {k: np.concatenate(v) for k, v in outs.items()}
    out["ys"] = np.asarray(ys_buf, np.int64)
    return out


def _dataset_paths(loader) -> List[str]:
    """Resolve the ordered file paths behind a (possibly Subset-wrapped)
    projection dataset."""
    ds = loader.dataset
    indices = None
    if hasattr(ds, "indices"):
        indices = ds.indices
        ds = ds.dataset
    base = getattr(ds, "base", ds)
    imgs = base.imgs
    if indices is not None:
        imgs = [imgs[i] for i in indices]
    return [p for p, _ in imgs]


def _load_resized(path, img_size):
    from PIL import Image
    with Image.open(path) as im:
        return im.convert("RGB").resize((img_size, img_size),
                                        Image.BILINEAR)


def _save_grid(images, path: str, nrow: int = 10, pad: int = 1,
               labels: Optional[List[str]] = None):
    """PIL replacement for torchvision.utils.make_grid + save_image."""
    from PIL import Image, ImageDraw
    if not images:
        return
    w, h = images[0].size
    label_h = 12 if labels else 0
    n = len(images)
    rows = (n + nrow - 1) // nrow
    grid = Image.new(
        "RGB", (nrow * (w + pad) + pad, rows * (h + pad + label_h) + pad),
        (255, 255, 255))
    draw = ImageDraw.Draw(grid)
    for i, im in enumerate(images):
        r, c = divmod(i, nrow)
        x = pad + c * (w + pad)
        y = pad + r * (h + pad + label_h)
        grid.paste(im, (x, y))
        if labels:
            draw.text((x, y + h), labels[i], fill=(0, 0, 0))
    grid.save(path)


def _importance(model):
    """Per-prototype importance [P]: the virtual weights' max over classes
    for a Count-PIPNet, the classifier weight's for a PIP-Net."""
    if isinstance(model, CountPIPNet):
        return importance_per_class(model).cpu().numpy().max(axis=0)
    return model.classification.weight.detach().cpu().numpy().max(axis=0)


def _importance_filter(model, are_pretraining: bool):
    """Prototypes worth rendering: max classifier weight > 1e-1, or all
    during pretraining (reference vis_pipnet.py:114-118,192)."""
    num_p = model.num_prototypes
    if are_pretraining:
        return list(range(num_p)), np.ones(num_p)
    per_proto = _importance(model)
    keep = [p for p in range(num_p) if per_proto[p] > 1e-1]
    return keep, per_proto


DEFAULT_CLASS_TO_COUNT = {(1, 3): 1, (4, 6): 2, (7, 9): 3}


def _count_from_class(class_label: int,
                      mapping=None) -> Optional[int]:
    """Shapes-dataset class -> object count (reference
    vis_pipnet.py:533-546; classes 1-3 have count 1, etc.)."""
    mapping = mapping or DEFAULT_CLASS_TO_COUNT
    for (start, end), count in mapping.items():
        if start <= class_label + 1 <= end:
            return count
    return None


def select_topk(stats, keep, k, is_count) -> Dict[int, List[Tuple[int,
                                                                  float]]]:
    """Each kept prototype's top-k (image index, pooled score): per count
    group for a Count-PIPNet (count-uniform sampling, reference
    vis_pipnet.py:652-833), plain top-k for a PIP-Net."""
    n = stats["pooled"].shape[0]
    groups: Dict[int, List[int]] = {}
    if is_count:
        for i in range(n):
            cnt = _count_from_class(int(stats["ys"][i]))
            groups.setdefault(cnt or 0, []).append(i)
    counts_sorted = sorted(c for c in groups if c > 0) or sorted(groups)
    per_group = max(1, k // max(len(counts_sorted), 1))
    topks = {}
    for p in keep:
        scores = stats["pooled"][:, p]
        if is_count:
            chosen = []
            for cnt in counts_sorted:
                order = sorted(groups[cnt], key=lambda i: -scores[i])
                chosen += [(i, float(scores[i])) for i in order[:per_group]]
        else:
            order = np.argsort(-scores)[:k]
            chosen = [(int(i), float(scores[i])) for i in order]
        topks[p] = chosen
    return topks


def _latent_geometry(stats, model, args):
    """(patchsize, skip, softmaxes_shape) of the latent grid."""
    n = stats["pooled"].shape[0]
    wshape = getattr(args, "wshape", None)
    latent_w = int(stats["w_idx"].max()) + 1 if n else (wshape or 1)
    latent_h = int(stats["h_idx"].max()) + 1 if n else (wshape or 1)
    if wshape:
        latent_h = latent_w = wshape
    patchsize, skip = get_patch_size(args.image_size, latent_w)
    return patchsize, skip, (model.num_prototypes, latent_h, latent_w)


def vizualize_network(trainer, projectloader, num_classes, foldername, args,
                      k=10, verbose=True, are_pretraining_prototypes=False,
                      plot_histograms=False, visualize_prototype_maps=False,
                      max_feature_maps_per_prototype=3, plot_topk=True,
                      histogram_return_type="mean_values",
                      filter_outlier_prototypes=True):
    """Dispatcher (reference vis_pipnet.py:30-66): Count-PIPNet models get
    count-grouped buffers, PIP-Net gets plain top-k. Returns the top-k
    picks ({prototype: [(image index, score)]}). The JAX function's
    keyword options that it ignores are left out.

    ``trainer`` is a train.trainer.Trainer (or any object with ``.model``,
    ``.tau`` and ``.dtype``).
    """
    model = trainer.model
    tau = getattr(trainer, "tau", 1.0)
    dtype = getattr(trainer, "dtype", "float32")

    out_dir = os.path.join(args.log_dir, foldername)
    os.makedirs(out_dir, exist_ok=True)

    stats = score_projection_set(model, projectloader, tau=tau, dtype=dtype)
    paths = _dataset_paths(projectloader)
    n = stats["pooled"].shape[0]
    assert len(paths) >= n, "path bookkeeping out of sync"

    keep, _ = _importance_filter(model, are_pretraining_prototypes)
    if verbose:
        print(f"Visualizing {len(keep)} prototypes "
              f"(of {model.num_prototypes})...", flush=True)

    img_size = args.image_size
    patchsize, skip, softmaxes_shape = _latent_geometry(stats, model, args)
    is_count = isinstance(model, CountPIPNet)
    topks = select_topk(stats, keep, k, is_count)

    # ---- render patches & grids ----
    all_grid_images, all_grid_labels = [], []
    for p in keep:
        proto_dir = os.path.join(out_dir, f"prototype_{p}")
        patch_images = []
        patch_labels = []
        for rank, (i, score) in enumerate(topks[p]):
            if score <= 0.0:
                continue
            h0, h1, w0, w1 = get_img_coordinates(
                img_size, softmaxes_shape, patchsize, skip,
                int(stats["h_idx"][i, p]), int(stats["w_idx"][i, p]))
            img = _load_resized(paths[i], img_size)
            patch = img.crop((w0, h0, w1, h1))
            if plot_topk:
                os.makedirs(proto_dir, exist_ok=True)
                patch.save(os.path.join(
                    proto_dir, f"p{p}_{rank}_sim{score:.3f}.png"))
            patch_images.append(patch)
            if is_count:
                cnt = _count_from_class(int(stats["ys"][i]))
                patch_labels.append(f"c{cnt} {score:.2f}")
            else:
                patch_labels.append(f"{score:.2f}")
        if patch_images:
            _save_grid(patch_images,
                       os.path.join(out_dir, f"grid_topk_{p}.png"),
                       nrow=min(10, max(len(patch_images), 1)),
                       labels=patch_labels)
            all_grid_images += patch_images[:min(len(patch_images), k)]
            all_grid_labels += [f"P{p}"] * min(len(patch_images), k)

    if all_grid_images:
        _save_grid(all_grid_images,
                   os.path.join(out_dir, "grid_topk_all.png"), nrow=k,
                   labels=all_grid_labels)

    if visualize_prototype_maps:
        _render_prototype_maps(model, tau, dtype, topks, paths, stats,
                               out_dir, img_size,
                               max_feature_maps_per_prototype,
                               softmaxes_shape, patchsize, skip,
                               is_count=is_count)

    if plot_histograms:
        try:
            from .histograms import plot_prototype_activations_by_class
            plot_prototype_activations_by_class(
                trainer, projectloader, num_classes,
                os.path.join(out_dir, "histograms"), args,
                return_type=histogram_return_type,
                filter_outlier_prototypes=filter_outlier_prototypes)
        except Exception as e:
            print(f"(histograms skipped: {e})", flush=True)

    return topks


def visualize_all_patches(trainer, projectloader, foldername, args,
                          threshold=0.5):
    """Legacy full-patch dump: every image patch whose prototype activation
    exceeds ``threshold``, one directory per prototype
    (reference vis_pipnet.py:1046-1159 ``visualize``)."""
    model = trainer.model
    stats = score_projection_set(model, projectloader,
                                 tau=getattr(trainer, "tau", 1.0),
                                 dtype=getattr(trainer, "dtype", "float32"))
    paths = _dataset_paths(projectloader)
    out_dir = os.path.join(args.log_dir, foldername)
    img_size = args.image_size
    wshape = getattr(args, "wshape", int(stats["w_idx"].max()) + 1)
    patchsize, skip = get_patch_size(img_size, wshape)
    shape = (model.num_prototypes, wshape, wshape)

    for p in range(model.num_prototypes):
        hits = np.where(stats["pooled"][:, p] > threshold)[0]
        if hits.size == 0:
            continue
        pdir = os.path.join(out_dir, f"prototype_{p}")
        os.makedirs(pdir, exist_ok=True)
        for i in hits:
            h0, h1, w0, w1 = get_img_coordinates(
                img_size, shape, patchsize, skip,
                int(stats["h_idx"][i, p]), int(stats["w_idx"][i, p]))
            img = _load_resized(paths[int(i)], img_size)
            score = float(stats["pooled"][i, p])
            img.crop((w0, h0, w1, h1)).save(os.path.join(
                pdir, f"img{int(i)}_sim{score:.3f}.png"))
    print(f"Full patch dump written to {out_dir}", flush=True)


def _zoom_bilinear(fm, out_h, out_w):
    """Upsample a 2-D feature map to pixel resolution (the reference's
    scipy.ndimage.zoom, here Pillow's bilinear resize)."""
    from PIL import Image
    im = Image.fromarray(fm.astype(np.float32), mode="F")
    return np.asarray(im.resize((out_w, out_h), Image.BILINEAR))


def _select_pipnet_examples(items, max_maps):
    """Highest, middle, and lowest-still->0.1 activation examples
    (reference vis_pipnet.py:371-391)."""
    sel = [0]
    if len(items) > 2:
        sel.append(len(items) // 2)
    if len(items) > 1:
        lo = len(items) - 1
        while lo > 0 and items[lo][1] < 0.1:
            lo -= 1
        if lo not in sel:
            sel.append(lo)
    return sel[:max_maps]


def _render_prototype_maps(model, tau, dtype, topks, paths, stats, out_dir,
                           img_size, max_maps, softmaxes_shape, patchsize,
                           skip, is_count=False):
    """Rich prototype feature-map renders, reproducing the reference's
    artifact set (util/vis_pipnet.py:354-486 PIPNet, :888-1032 Count):

      feature_maps/prototype_<p>/<base>_original.png     image + patch rect
      feature_maps/prototype_<p>/<base>_feature_map.png  side-by-side heatmap
      feature_maps/prototype_<p>/<base>_overlay.png      masked zoomed overlay
      feature_maps/prototype_<p>/<base>_debug.txt        (count variant)

    PIPNet selection: highest / middle / lowest>0.1 activation; Count
    selection: best example per count group (by the model's own count).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data import augment as A

    device = _model_device(model)
    generator = torch.Generator(device).manual_seed(1)
    normalize = A.Compose([A.ToArray(), A.Normalize()])
    feature_maps_dir = os.path.join(out_dir, "feature_maps")

    for p, items in topks.items():
        items = [(i, s) for (i, s) in items if s > 0]
        if not items:
            continue
        proto_dir = os.path.join(feature_maps_dir, f"prototype_{p}")
        os.makedirs(proto_dir, exist_ok=True)

        if is_count:
            # best example per count group, ranked by the model's count
            groups: Dict[int, Tuple[int, float]] = {}
            for (i, s) in items:
                cnt = _count_from_class(int(stats["ys"][i])) or 0
                model_count = float(stats["pooled"][i, p])
                if cnt not in groups or model_count > groups[cnt][1]:
                    groups[cnt] = (i, model_count)
            selected = [(i, mc, cnt)
                        for cnt, (i, mc) in sorted(groups.items())]
            selected = selected[:max_maps]
        else:
            idxs = _select_pipnet_examples(items, max_maps)
            selected = [(items[r][0], items[r][1], None) for r in idxs]

        for rank, (i, score, cnt) in enumerate(selected):
            img = _load_resized(paths[i], img_size)
            img_np = np.asarray(img).astype(np.float32) / 255.0
            xs = torch.from_numpy(np.asarray(normalize(img, None))[None])
            proto, _ = _inference(model, xs.to(device), tau=tau,
                                  generator=generator, dtype=dtype)
            fm = proto[0, :, :, p].cpu().numpy()
            h_idx = int(stats["h_idx"][i, p])
            w_idx = int(stats["w_idx"][i, p])
            h0, h1, w0, w1 = get_img_coordinates(
                img_size, softmaxes_shape, patchsize, skip, h_idx, w_idx)

            if is_count:
                cls = int(stats["ys"][i])
                base = (f"proto_{p}_count_{cnt}_model_count_{score:.1f}"
                        f"_class_{cls}")
                title = (f"Prototype {p} - Count: {cnt} "
                         f"(Model Count: {score:.1f}, Class: {cls})")
                with open(os.path.join(proto_dir, f"{base}_debug.txt"),
                          "w") as f:
                    f.write(
                        f"Prototype {p} Count Statistics:\n"
                        f"Count Group (from class): {cnt}\n"
                        f"Model Count Value: {score:.3f}\n"
                        f"Class Label: {cls}\n"
                        f"Feature map shape: {fm.shape}\n"
                        f"Feature map sum: {fm.sum():.3f}\n"
                        f"Feature map max value: {fm.max():.3f}\n"
                        f"Feature map mean: {fm.mean():.3f}\n")
            else:
                base = (f"proto_{p}_rank_{rank + 1}_of_{len(selected)}"
                        f"_score_{score:.3f}")
                title = (f"Prototype {p} - Activation: {score:.3f} "
                         f"(Map Sum: {fm.sum():.3f})")

            def rect():
                return plt.Rectangle((w0, h0), w1 - w0, h1 - h0,
                                     fill=False, edgecolor="yellow",
                                     linewidth=2)

            # 1. original + patch rectangle
            plt.figure(figsize=(6, 5))
            plt.imshow(img_np)
            plt.gca().add_patch(rect())
            plt.axis("off")
            plt.title(title, fontsize=9)
            plt.tight_layout()
            plt.savefig(os.path.join(proto_dir, f"{base}_original.png"),
                        bbox_inches="tight", dpi=100)
            plt.close()

            # 2. side-by-side original(+rect) and heatmap with argmax X
            fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 5))
            ax1.imshow(img_np)
            ax1.add_patch(rect())
            ax1.set_title("Original Image")
            ax1.axis("off")
            hm = ax2.imshow(fm, cmap="viridis")
            ax2.scatter(w_idx, h_idx, marker="x", color="red", s=100)
            ax2.set_title("Feature Map Heatmap")
            ax2.axis("off")
            fig.colorbar(hm, ax=ax2, label="Activation")
            plt.suptitle(title, fontsize=9)
            plt.tight_layout()
            plt.savefig(os.path.join(proto_dir, f"{base}_feature_map.png"),
                        bbox_inches="tight", dpi=100)
            plt.close()

            # 3. masked zoomed overlay (activations > 0.1 only)
            resized = _zoom_bilinear(fm, img_np.shape[0], img_np.shape[1])
            mask = resized > 0.1
            colored = matplotlib.colormaps["viridis"](
                np.clip(resized, 0.0, 1.0))
            overlay = np.zeros((*resized.shape, 4), np.float32)
            overlay[mask] = colored[mask]
            overlay[mask, 3] = 0.7
            plt.figure(figsize=(6, 5))
            plt.imshow(img_np)
            plt.imshow(overlay, alpha=0.7)
            plt.gca().add_patch(rect())
            plt.title(title, fontsize=9)
            plt.axis("off")
            plt.tight_layout()
            plt.savefig(os.path.join(proto_dir, f"{base}_overlay.png"),
                        bbox_inches="tight", dpi=100)
            plt.close()
