"""Config-driven saliency attribution for trained runs.

Port of count_pipnet_tpu/interpret/interpret_idg.py (reference
util/interpret_idg.py): load a trained run from its pickled args and a
checkpoint role (the port's ``torch.save`` files or a JAX run's flax
msgpack files, utils/checkpoint.py), expose its logits or one
prototype's pooled score as the attribution target, select the active
prototypes of an image above a threshold of virtual-weight-scaled
activation, run IG / LeftIG / IDG / Guided IG on each and blend coloured
overlays; plus a whole-dataset logit-attribution mode.

The attribution forward is the model's own inference forward in f32
(autocast off) on the model's device: hard Gumbel samples with their
straight-through gradient for a Count-PIPNet, the softmax add-on and max
pool for a PIP-Net. Each call draws its Gumbel noise from a generator
reseeded with the same seed, so a score is a deterministic function of
the image and its batch position, as with the JAX package's fixed key.

    python -m count_pipnet_tpu_torch.interpret.interpret_idg \\
        --run_dir ./runs/<run> [--method IDG] [--disable_cuda]
"""

import os
import pickle
import sys
from typing import Dict, List

import numpy as np
import torch

from ..data import augment as A
from ..models.pipnet import (CountPIPNet, get_count_network, get_pipnet,
                             importance_per_class)
from ..utils.checkpoint import CheckpointManager
from .saliency import IDG, IG, guided_ig, visualize_grayscale

__all__ = ["GLOBAL_CFG", "load_model_for_interpretation",
           "make_logit_fn", "make_prototype_fn", "interpret",
           "interpret_prototypes", "interpret_logits_for_dataset"]

# Default configuration (reference interpret_idg.py:46-99)
GLOBAL_CFG: Dict = {
    "run_dir": "",                 # trained run directory (with metadata/)
    "checkpoint": "net_best",      # which checkpoint role to load
    "method": "IDG",               # IG | LIG | IDG | GIG
    "steps": 128,
    "batch_size": 32,
    "alpha_star": 0.33,            # LeftIG cutoff
    "baseline": 0.0,
    "prototype_threshold": 0.1,    # min weighted activation to attribute
    "images_per_class": 2,         # random sampling mode
    "seed": 0,
    "output_dir": "idg_attributions",
    "overlay_alpha": 0.6,
}

# distinct RGB colors for per-prototype overlay blending
_COLORS = np.asarray([
    (228, 26, 28), (55, 126, 184), (77, 175, 74), (152, 78, 163),
    (255, 127, 0), (255, 255, 51), (166, 86, 40), (247, 129, 191),
    (153, 153, 153), (0, 200, 200), (100, 0, 200), (200, 200, 0),
], dtype=np.float32)


def _device_of(model):
    return next(model.parameters()).device


def load_model_for_interpretation(run_dir: str, checkpoint="net_best",
                                  device="cuda"):
    """Rebuild a trained model from its saved args and checkpoint on
    ``device`` (reference interpret_idg.py:138-180). The device is the
    caller's, never the pickled ``disable_cuda``.

    Returns (model, args).
    """
    args_path = os.path.join(run_dir, "metadata", "args.pickle")
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    args.log_dir = run_dir

    if getattr(args, "model", "pipnet") == "count_pipnet":
        builder = lambda n: get_count_network(  # noqa: E731
            n, args, max_count=getattr(args, "max_count", 3),
            use_ste=getattr(args, "use_ste", False))
    else:
        builder = lambda n: get_pipnet(n, args)  # noqa: E731

    ckpt = CheckpointManager(args)
    res = (ckpt.load_best_checkpoint() if checkpoint == "net_best"
           else ckpt.load_trained_checkpoint(name=checkpoint))
    if res is None:
        raise FileNotFoundError(
            f"no '{checkpoint}' checkpoint under {run_dir}")
    state, _meta = res
    num_classes = (getattr(args, "num_classes", None)
                   or state["model"]["classification.weight"].shape[0])
    model, _ = builder(num_classes)
    model.load_state_dict(state["model"])
    return model.to(device), args


def _forward(model, xs, tau, seed):
    """The inference forward in f32 with a freshly seeded generator on the
    inputs' device."""
    gen = torch.Generator(xs.device).manual_seed(seed)
    with torch.autocast(xs.device.type, enabled=False):
        return model(xs, inference=True, train=False, tau=tau,
                     generator=gen)


def make_logit_fn(model, tau=1.0, seed=0):
    """[B,H,W,C] -> [B, num_classes] logits (reference PIPNetWrapper)."""

    def fn(xs):
        return _forward(model, xs, tau, seed)[2].float()

    return fn


def make_prototype_fn(model, prototype_idx, tau=1.0, seed=0):
    """[B,H,W,C] -> [B] pooled activation of one prototype
    (reference PIPNetPrototypeWrapper)."""

    def fn(xs):
        return _forward(model, xs, tau, seed)[1][:, prototype_idx].float()

    return fn


def _weighted_activations(model, pooled, class_idx):
    """Per-prototype weighted activation for a class: virtual weights for
    Count-PIPNet, raw classifier weights otherwise
    (reference interpret_idg.py:337-366)."""
    if isinstance(model, CountPIPNet):
        w = importance_per_class(model).cpu().numpy()
    else:
        w = model.classification.weight.detach().cpu().numpy()
    return pooled * w[class_idx]


def _attribute(method, cfg, x, fn, device):
    if method == "IG":
        return IG(x, fn, steps=cfg["steps"], batch_size=cfg["batch_size"],
                  alpha_star=1.0, baseline=cfg["baseline"], device=device)
    if method == "LIG":
        return IG(x, fn, steps=cfg["steps"], batch_size=cfg["batch_size"],
                  alpha_star=cfg["alpha_star"], baseline=cfg["baseline"],
                  device=device)
    if method == "IDG":
        return IDG(x, fn, steps=cfg["steps"], batch_size=cfg["batch_size"],
                   baseline=cfg["baseline"], device=device)
    if method == "GIG":
        return guided_ig(x, fn, steps=min(cfg["steps"], 64),
                         baseline=cfg["baseline"], device=device)
    raise ValueError(f"unknown attribution method {method}")


def _normalized(img, img_size):
    normalize = A.Compose([A.Resize(img_size), A.ToArray(), A.Normalize()])
    return normalize(img, None)[None].astype(np.float32)


def interpret_prototypes(model, img, args, cfg=None):
    """Attribute each sufficiently-active prototype on one PIL image and
    blend coloured overlays (reference interpret_idg.py:337-470); the
    Gumbel noise's seed is ``cfg["seed"]``.

    Returns (overlay PIL image, {prototype: attribution map}).
    """
    from PIL import Image
    cfg = dict(GLOBAL_CFG, **(cfg or {}))
    seed = cfg["seed"]
    device = _device_of(model)
    img_size = args.image_size
    x = _normalized(img, img_size)

    with torch.no_grad():
        _, pooled, out = _forward(
            model, torch.from_numpy(x).to(device), 1.0, seed)
    pred = int(out.float().cpu().numpy()[0].argmax())
    pooled = pooled.float().cpu().numpy()[0]

    weighted = _weighted_activations(model, pooled, pred)
    active = np.where(weighted > cfg["prototype_threshold"])[0]

    attributions = {}
    blended = np.zeros((img_size, img_size, 3), np.float32)
    for j, p in enumerate(active):
        fn = make_prototype_fn(model, int(p), seed=seed)
        attr = _attribute(cfg["method"], cfg, x, fn, device)
        gray = visualize_grayscale(attr)
        color = _COLORS[j % len(_COLORS)] / 255.0
        blended += gray[..., None] * color[None, None, :]
        attributions[int(p)] = attr

    blended = np.clip(blended, 0, 1)
    base = np.asarray(
        img.convert("RGB").resize((img_size, img_size)), np.float32) / 255.0
    alpha = cfg["overlay_alpha"]
    overlay = np.clip((1 - alpha) * base + alpha * blended, 0, 1)
    overlay_img = Image.fromarray((overlay * 255).astype(np.uint8))
    return overlay_img, attributions


def _projection_base(args):
    """(the projection set's ImageFolder, class names) of a run."""
    from ..data.registry import get_data
    (_, _, _, _, projectset, _, _, classes, _, _, _) = get_data(args)
    return getattr(projectset, "base", projectset), classes


def interpret(cfg=None, model=None, args=None, device="cuda"):
    """Config-driven entry (reference interpret_idg.py:207): sample
    images_per_class images per class from the run's projection set and
    attribute their active prototypes. ``model`` and ``args`` (a live
    trainer's) replace loading ``cfg["run_dir"]`` onto ``device``."""
    from PIL import Image
    cfg = dict(GLOBAL_CFG, **(cfg or {}))
    if model is None:
        model, args = load_model_for_interpretation(
            cfg["run_dir"], cfg["checkpoint"], device)
    base, classes = _projection_base(args)

    by_class: Dict[int, List[int]] = {}
    for i, t in enumerate(base.targets):
        by_class.setdefault(t, []).append(i)

    out_dir = os.path.join(args.log_dir, cfg["output_dir"])
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(cfg["seed"])
    for cls_idx, idxs in sorted(by_class.items()):
        chosen = rng.choice(idxs, size=min(cfg["images_per_class"],
                                          len(idxs)), replace=False)
        for i in chosen:
            path = base.imgs[i][0]
            img = Image.open(path).convert("RGB")
            overlay, attrs = interpret_prototypes(model, img, args, cfg)
            name = os.path.splitext(os.path.basename(path))[0]
            overlay.save(os.path.join(
                out_dir, f"{classes[cls_idx]}_{name}_{cfg['method']}.png"))
            print(f"attributed {path}: {len(attrs)} active prototypes",
                  flush=True)
    print(f"Attribution overlays saved to {out_dir}", flush=True)


def interpret_logits_for_dataset(cfg=None, max_images=50, device="cuda"):
    """Logit-target attribution over a dataset sample
    (reference interpret_idg.py:587), on ``device``."""
    from PIL import Image
    cfg = dict(GLOBAL_CFG, **(cfg or {}))
    model, args = load_model_for_interpretation(
        cfg["run_dir"], cfg["checkpoint"], device)
    base, classes = _projection_base(args)

    out_dir = os.path.join(args.log_dir, cfg["output_dir"] + "_logits")
    os.makedirs(out_dir, exist_ok=True)
    logit_fn = make_logit_fn(model)
    for i in range(min(max_images, len(base.imgs))):
        path = base.imgs[i][0]
        img = Image.open(path).convert("RGB")
        x = _normalized(img, args.image_size)
        with torch.no_grad():
            out = logit_fn(torch.from_numpy(x).to(device))
        pred = int(out.cpu().numpy()[0].argmax())
        attr = _attribute(cfg["method"], cfg, x,
                          lambda xs: logit_fn(xs)[:, pred], device)
        gray = visualize_grayscale(attr)
        Image.fromarray((gray * 255).astype(np.uint8)).save(
            os.path.join(out_dir, f"{i}_{classes[pred]}.png"))
    print(f"Logit attributions saved to {out_dir}", flush=True)


def _cli(argv=None):
    """The JAX package's flags (its GLOBAL_CFG keys) plus
    ``--disable_cuda``; without it a CUDA device is required."""
    import argparse

    ap = argparse.ArgumentParser(
        "Prototype/logit saliency attribution for a trained run")
    ap.add_argument("--run_dir", type=str, required=True)
    ap.add_argument("--checkpoint", type=str,
                    default=GLOBAL_CFG["checkpoint"])
    ap.add_argument("--method", type=str, default=GLOBAL_CFG["method"],
                    choices=["IG", "LIG", "IDG", "GIG"])
    ap.add_argument("--steps", type=int, default=GLOBAL_CFG["steps"])
    ap.add_argument("--images_per_class", type=int,
                    default=GLOBAL_CFG["images_per_class"])
    ap.add_argument("--prototype_threshold", type=float,
                    default=GLOBAL_CFG["prototype_threshold"])
    ap.add_argument("--output_dir", type=str,
                    default=GLOBAL_CFG["output_dir"])
    ap.add_argument("--seed", type=int, default=GLOBAL_CFG["seed"])
    ap.add_argument("--mode", type=str, default="prototypes",
                    choices=["prototypes", "logits"])
    ap.add_argument("--max_images", type=int, default=50,
                    help="logits mode: dataset images to attribute")
    ap.add_argument("--disable_cuda", action="store_true",
                    help="run on the CPU; without it a CUDA device is "
                         "required")
    cli = ap.parse_args(argv)
    if not cli.disable_cuda and not torch.cuda.is_available():
        print("error: no CUDA device; pass --disable_cuda to run on the "
              "CPU", file=sys.stderr)
        return 2
    device = "cpu" if cli.disable_cuda else "cuda"

    cfg = dict(GLOBAL_CFG)
    for k in ("run_dir", "checkpoint", "method", "steps",
              "images_per_class", "prototype_threshold", "output_dir",
              "seed"):
        cfg[k] = getattr(cli, k)
    cfg["batch_size"] = min(cfg["batch_size"], cli.steps)
    if cli.mode == "prototypes":
        interpret(cfg, device=device)
    else:
        interpret_logits_for_dataset(cfg, max_images=cli.max_images,
                                     device=device)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
