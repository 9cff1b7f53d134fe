"""Per-image prediction explanations.

Port of count_pipnet_tpu/interpret/visualize_prediction.py (reference
util/visualize_prediction.py: vis_pred :19-100, vis_pred_experiments
:102-169). For a handful of test images per class, for the top-3
predicted classes, saves per-prototype patch crops and rectangle-overlay
images named ``mul{sim*w:.3f}_p{idx}_sim{sim:.3f}_w{w:.3f}_patch.png`` /
``_rect.png`` for contributions with |sim x weight| > 0.01.

The prediction forward is the model's inference forward on the model's
device, in the trainer's dtype (``--dtype bfloat16``: autocast), one
image at a time, its Gumbel noise drawn from one generator seeded 11
(13 for the experiments folder). The heatmaps (matplotlib's jet
colormap) are off by default.
"""

import os

import numpy as np
import torch

from ..data import augment as A
from ..models.pipnet import CountPIPNet, importance_per_class
from ..train.steps import autocast_for
from ..utils.func import get_patch_size
from .vis_pipnet import get_img_coordinates

__all__ = ["vis_pred", "vis_pred_experiments"]


@torch.no_grad()
def _predict(model, xs, tau, generator, dtype):
    """f32 (prototype maps [B, H, W, P], pooled [B, P], logits [B, C])."""
    with autocast_for(xs.device, dtype):
        proto, pooled, out = model(xs, inference=True, train=False, tau=tau,
                                   generator=generator)
    return proto.float(), pooled.float(), out.float()


def _class_weights(model):
    """[C, P]: the virtual weights of a Count-PIPNet, the classifier's of
    a PIP-Net."""
    if isinstance(model, CountPIPNet):
        return importance_per_class(model).cpu().numpy()
    return model.classification.weight.detach().cpu().numpy()


def _explain_image(model, img_path, img_size, out_root, classes, tau,
                   generator, dtype, save_heatmaps=False, top_classes=3):
    from PIL import Image, ImageDraw
    normalize = A.Compose([A.Resize(img_size), A.ToArray(), A.Normalize()])
    img = Image.open(img_path).convert("RGB").resize(
        (img_size, img_size), Image.BILINEAR)
    xs = normalize(Image.open(img_path).convert("RGB"), None)[None]
    device = next(model.parameters()).device
    proto, pooled, out = _predict(
        model, torch.as_tensor(xs, dtype=torch.float32, device=device), tau,
        generator, dtype)
    proto, pooled, out = (t[0].cpu().numpy() for t in (proto, pooled, out))
    weights = _class_weights(model)

    h, w, num_p = proto.shape
    latent_shape = (num_p, h, w)
    patchsize, skip = get_patch_size(img_size, w)

    order = np.argsort(-out)[:top_classes]
    img_name = os.path.splitext(os.path.basename(img_path))[0]
    for rank, c in enumerate(order):
        cname = classes[c] if classes and c < len(classes) else str(c)
        cdir = os.path.join(
            out_root, img_name,
            f"{rank}_{cname}_output{out[c]:.3f}")
        for p in range(num_p):
            sim = float(pooled[p])
            wt = float(weights[c, p])
            mul = abs(sim * wt)
            if mul <= 0.01:
                continue
            os.makedirs(cdir, exist_ok=True)
            hw = int(np.argmax(proto[:, :, p]))
            h_idx, w_idx = hw // w, hw % w
            h0, h1, w0, w1 = get_img_coordinates(
                img_size, latent_shape, patchsize, skip, h_idx, w_idx)
            stem = f"mul{mul:.3f}_p{p}_sim{sim:.3f}_w{wt:.3f}"
            img.crop((w0, h0, w1, h1)).save(
                os.path.join(cdir, stem + "_patch.png"))
            rect = img.copy()
            ImageDraw.Draw(rect).rectangle([w0, h0, w1, h1],
                                           outline=(255, 255, 0), width=2)
            rect.save(os.path.join(cdir, stem + "_rect.png"))
            if save_heatmaps:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.cm as cm
                pm = proto[:, :, p]
                pm = pm / (pm.max() + 1e-8)
                heat = cm.jet(np.asarray(Image.fromarray(
                    (pm * 255).astype(np.uint8)).resize(
                        (img_size, img_size), Image.BILINEAR)) / 255.0)
                heat_img = Image.fromarray(
                    (heat[..., :3] * 255).astype(np.uint8))
                Image.blend(img, heat_img, 0.5).save(
                    os.path.join(cdir, stem + "_heatmap.png"))


def _setup(trainer, seed):
    """(model, tau, dtype, generator) of a trainer-like object (``.model``,
    optional ``.tau`` and ``.dtype``)."""
    model = trainer.model
    device = next(model.parameters()).device
    return (model, getattr(trainer, "tau", 1.0),
            getattr(trainer, "dtype", "float32"),
            torch.Generator(device).manual_seed(seed))


def vis_pred(trainer, test_dir, classes, args, n_per_class=5,
             save_heatmaps=False):
    """Explain up to n_per_class test images per class
    (reference visualize_prediction.py:19-100)."""
    model, tau, dtype, gen = _setup(trainer, 11)
    out_root = os.path.join(args.log_dir, args.dir_for_saving_images)
    for cls in sorted(os.listdir(test_dir)):
        cdir = os.path.join(test_dir, cls)
        if not os.path.isdir(cdir):
            continue
        files = sorted(os.listdir(cdir))[:n_per_class]
        for fname in files:
            _explain_image(model, os.path.join(cdir, fname),
                           args.image_size, out_root, classes, tau, gen,
                           dtype, save_heatmaps=save_heatmaps)
    print(f"Prediction explanations saved under {out_root}", flush=True)


def vis_pred_experiments(trainer, experiments_dir, classes, args,
                         save_heatmaps=False):
    """Explain every image in an OOD/extra folder, all classes
    (reference visualize_prediction.py:102-169)."""
    model, tau, dtype, gen = _setup(trainer, 13)
    out_root = os.path.join(args.log_dir,
                            args.dir_for_saving_images + "_experiments")
    for dirpath, _dirs, files in os.walk(experiments_dir):
        for fname in sorted(files):
            if not fname.lower().endswith(
                    (".png", ".jpg", ".jpeg", ".bmp")):
                continue
            _explain_image(model, os.path.join(dirpath, fname),
                           args.image_size, out_root, classes, tau, gen,
                           dtype, save_heatmaps=save_heatmaps)
    print(f"Experiment explanations saved under {out_root}", flush=True)
