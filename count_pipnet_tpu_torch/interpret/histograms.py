"""Prototype activation histograms and reports.

Port of count_pipnet_tpu/interpret/histograms.py (reference
util/histograms.py: plot_prototype_activations_by_class :383-943, the
simpler plot_prototype_activations_histograms :945-1214), on matplotlib.
The activations are collected in batches of the model's inference forward
on its device under ``torch.no_grad()``.

Artifacts per run: per-prototype class-conditional histograms (discrete
count bars for Count-PIPNet, 50-bin continuous for PIP-Net), a class x
prototype mean-activation heatmap, a near-zero prototype report txt, and an
HTML index. Returns per-class mean activations and/or non-zero counts
(reference :936-943).
"""

import os
from typing import Dict

import numpy as np
import torch

from ..models.pipnet import CountPIPNet
from .vis_pipnet import _importance, _inference, _model_device

__all__ = ["collect_activations", "plot_prototype_activations_by_class",
           "plot_prototype_activations_histograms"]

MAX_IMAGES = 10_000


def collect_activations(model, loader, *, tau=1.0, batch=64,
                        max_images=MAX_IMAGES, generator=None,
                        dtype="float32"):
    """Pooled activations + labels over (up to) max_images of a loader,
    in batches of ``batch`` on the model's device (``generator``: the
    Gumbel draw, a fresh one seeded 0 when None).

    Returns (activations [N, P], labels [N]).
    Reference: util/histograms.py:66-166 (_collect_activations).
    """
    device = _model_device(model)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    acts, labels = [], []
    buf_x, buf_y = [], []
    total = 0

    def flush():
        if not buf_x:
            return
        _, pooled = _inference(model, torch.stack(buf_x).to(device),
                               tau=tau, generator=generator, dtype=dtype)
        acts.append(pooled.cpu().numpy())
        labels.extend(buf_y)
        buf_x.clear()
        buf_y.clear()

    for item in loader:
        xs, ys = item[0], item[-1]
        for i in range(xs.shape[0]):
            if total >= max_images:
                break
            buf_x.append(torch.as_tensor(xs[i], dtype=torch.float32))
            buf_y.append(int(ys[i]))
            total += 1
            if len(buf_x) == batch:
                flush()
        if total >= max_images:
            break
    flush()
    if not acts:
        return np.zeros((0, model.num_prototypes)), np.zeros((0,), np.int64)
    return np.concatenate(acts), np.asarray(labels, np.int64)


def _zero_report(acts, out_dir, threshold=1e-3):
    """Near-zero prototype report (reference histograms.py:170-257)."""
    frac_zero = (np.abs(acts) <= threshold).mean(axis=0)
    lines = ["prototype,frac_near_zero,mean_nonzero_activation"]
    for p in range(acts.shape[1]):
        nz = acts[np.abs(acts[:, p]) > threshold, p]
        mean_nz = float(nz.mean()) if nz.size else 0.0
        lines.append(f"{p},{frac_zero[p]:.4f},{mean_nz:.4f}")
    path = os.path.join(out_dir, "zero_report.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return frac_zero


def _summary_heatmap(acts, labels, num_classes, keep, out_dir,
                     class_names=None):
    """Class x prototype mean-activation heatmap
    (reference histograms.py:261-378)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    means = np.zeros((num_classes, len(keep)))
    for ci in range(num_classes):
        mask = labels == ci
        if mask.any():
            means[ci] = acts[mask][:, keep].mean(axis=0)
    fig, ax = plt.subplots(
        figsize=(max(6, len(keep) * 0.4), max(4, num_classes * 0.35)))
    im = ax.imshow(means, aspect="auto", cmap="viridis")
    ax.set_xticks(range(len(keep)))
    ax.set_xticklabels([f"P{p}" for p in keep], rotation=90, fontsize=7)
    ax.set_yticks(range(num_classes))
    if class_names and len(class_names) == num_classes:
        ax.set_yticklabels(class_names, fontsize=7)
    ax.set_xlabel("Prototype")
    ax.set_ylabel("Class")
    fig.colorbar(im, label="Mean activation")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "summary_heatmap.png"), dpi=120)
    plt.close(fig)
    return means


def plot_prototype_activations_by_class(
        trainer, loader, num_classes, out_dir, args, *,
        histogram_type="per-class", return_type="mean_values",
        filter_outlier_prototypes=True, max_images=MAX_IMAGES,
        class_names=None, export_pdf=False):
    """Per-prototype class-conditional histograms + heatmap + zero report.

    ``export_pdf`` additionally writes each figure as a PDF (the
    reference exported PDF via plotly's orca engine, histograms.py:916;
    here it is plain matplotlib).

    Returns per-class mean activations and/or non-zero counts keyed like
    the reference (histograms.py:936-943).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    model = trainer.model
    acts, labels = collect_activations(
        model, loader, tau=getattr(trainer, "tau", 1.0),
        max_images=max_images, dtype=getattr(trainer, "dtype", "float32"))
    if acts.shape[0] == 0:
        return {}

    is_count = isinstance(model, CountPIPNet)

    # importance filter (histograms.py:510-537)
    imp = _importance(model)
    keep = [p for p in range(acts.shape[1]) if imp[p] > 1e-1] or \
        list(range(acts.shape[1]))

    # outlier filter by mean non-zero activation
    if filter_outlier_prototypes and len(keep) > 2:
        mean_nz = []
        for p in keep:
            nz = acts[np.abs(acts[:, p]) > 1e-3, p]
            mean_nz.append(nz.mean() if nz.size else 0.0)
        mean_nz = np.asarray(mean_nz)
        med = np.median(mean_nz[mean_nz > 0]) if (mean_nz > 0).any() else 0
        if med > 0:
            keep = [p for p, m in zip(keep, mean_nz) if m < 20 * med]

    _zero_report(acts, out_dir)
    _summary_heatmap(acts, labels, num_classes, keep, out_dir, class_names)

    html_entries = ["<h1>Prototype activation histograms</h1>",
                    '<img src="summary_heatmap.png"><hr>']
    max_count = getattr(model, "max_count", None)
    for p in keep:
        fig, ax = plt.subplots(figsize=(6, 3.5))
        for ci in range(num_classes):
            vals = acts[labels == ci, p]
            if not vals.size:
                continue
            name = (class_names[ci] if class_names and
                    len(class_names) == num_classes else f"class {ci}")
            if is_count and max_count:
                # discrete count bars (histograms.py:665-724)
                bins = np.arange(-0.5, max_count + 1.5, 1.0)
                ax.hist(np.clip(np.round(vals), 0, max_count), bins=bins,
                        alpha=0.5, label=name)
            else:
                ax.hist(vals, bins=50, alpha=0.5, label=name)
        ax.set_title(f"Prototype {p} (importance {imp[p]:.3f})")
        ax.set_xlabel("count" if is_count else "pooled activation")
        ax.legend(fontsize=6, ncol=2)
        fig.tight_layout()
        fname = f"hist_p{p}.png"
        fig.savefig(os.path.join(out_dir, fname), dpi=110)
        if export_pdf:
            fig.savefig(os.path.join(out_dir, f"hist_p{p}.pdf"))
        plt.close(fig)
        html_entries.append(f'<h3>Prototype {p}</h3><img src="{fname}">')

    with open(os.path.join(out_dir, "histograms.html"), "w") as f:
        f.write("\n".join(html_entries))

    # return values (histograms.py:936-943)
    result: Dict = {}
    if return_type in ("mean_values", "both"):
        means = {}
        for p in keep:
            per_class = {}
            for ci in range(num_classes):
                vals = acts[labels == ci, p]
                per_class[ci] = float(vals.mean()) if vals.size else 0.0
            means[p] = per_class
        result["mean_values"] = means
    if return_type in ("nonzero_counts", "both"):
        counts = {}
        for p in keep:
            per_class = {}
            for ci in range(num_classes):
                vals = acts[labels == ci, p]
                per_class[ci] = int((np.abs(vals) > 1e-3).sum())
            counts[p] = per_class
        result["nonzero_counts"] = counts
    return result


def plot_prototype_activations_histograms(trainer, loader, out_dir, args, *,
                                          max_images=MAX_IMAGES):
    """Simpler all-class histograms with shaded count-region bands
    (reference histograms.py:945-1214)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    model = trainer.model
    acts, _ = collect_activations(model, loader,
                                  tau=getattr(trainer, "tau", 1.0),
                                  max_images=max_images,
                                  dtype=getattr(trainer, "dtype", "float32"))
    if acts.shape[0] == 0:
        return
    max_count = getattr(model, "max_count", None)
    for p in range(acts.shape[1]):
        fig, ax = plt.subplots(figsize=(6, 3))
        ax.hist(acts[:, p], bins=50, color="#3069b3")
        if max_count:
            for c in range(max_count + 1):
                ax.axvspan(c - 0.5, c + 0.5, alpha=0.08,
                           color=["#999", "#4a4"][c % 2])
        ax.set_title(f"Prototype {p}")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"hist_all_p{p}.png"), dpi=110)
        plt.close(fig)
