"""Test-set evaluation.

Port of count_pipnet_tpu/train/eval.py (reference pipnet/test.py:12-185).
The per-batch statistics are train/steps.py:eval_stats; this module owns
the loop, the virtual weights, and the reference's destructive weight
shrink: before every batch the live classifier weight becomes
``max(w - 1e-3, 0)`` (test.py:71-73), in place, so it carries into
training as in the reference.
"""

import numpy as np
import torch

from ..models.pipnet import CountPIPNet, importance_per_class
from .steps import eval_stats

__all__ = ["evaluate", "class_prototype_weights", "acc_from_cm"]


def acc_from_cm(cm: np.ndarray) -> float:
    """Accuracy from a confusion matrix (reference test.py:248-264)."""
    total = cm.sum()
    return float(np.trace(cm) / total) if total > 0 else 1.0


def class_prototype_weights(model):
    """[num_classes, num_prototypes] effective weights: the virtual
    importance matrix of a Count-PIPNet (reference test.py:51-64)."""
    if isinstance(model, CountPIPNet):
        return importance_per_class(model)
    return model.classification.weight.detach()


def evaluate(model, test_loader, epoch, *, num_classes,
             enforce_weight_sparsity=True, generator=None, tau=1.0,
             dtype="float32", noises=None):
    """The full evaluation pass; returns the reference's info dict
    (test.py:149-157). ``noises``: optional per-batch Gumbel noise."""
    device = model.classification.weight.device
    cpw = class_prototype_weights(model)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    n_images = abstained = 0
    sums = dict.fromkeys(("top5_mean", "pred_class_sizes_mean",
                          "any_class_sizes_mean", "prototypes_per_class_mean",
                          "almost_nz_mean"), 0.0)
    for i, (xs, ys) in enumerate(test_loader):
        if enforce_weight_sparsity:
            with torch.no_grad():
                model.classification.weight.sub_(1e-3).clamp_(min=0.0)
        xs = torch.as_tensor(xs, dtype=torch.float32, device=device)
        ys = torch.as_tensor(ys, dtype=torch.int64, device=device)
        stats = eval_stats(model, xs, ys, cpw, num_classes=num_classes,
                           tau=tau, generator=generator, dtype=dtype,
                           noise=None if noises is None else noises[i])
        bs = int(ys.shape[0])
        n_images += bs
        cm += stats["cm"].cpu().numpy()
        abstained += int(stats["abstained"])
        for k in sums:
            sums[k] += float(stats[k]) * bs
    print(f"PIP-Net abstained from a decision for {abstained} images",
          flush=True)
    w = model.classification.weight.detach().cpu().numpy()
    num_nonzero = int((cpw.cpu().numpy() > 1e-3).any(axis=0).sum())
    sparsity = (w.size - np.count_nonzero(np.maximum(w - 1e-3, 0))) / w.size
    print("sparsity ratio:", sparsity, flush=True)
    n = max(n_images, 1)
    return {
        "num non-zero prototypes": num_nonzero,
        "confusion_matrix": cm,
        "test_accuracy": acc_from_cm(cm),
        "top1_accuracy": acc_from_cm(cm),
        "top5_accuracy": sums["top5_mean"] / n,
        "local_size_for_true_class": sums["pred_class_sizes_mean"] / n,
        "local_size_for_all_classes": sums["any_class_sizes_mean"] / n,
        "prototypes_per_class": sums["prototypes_per_class_mean"] / n,
        "almost_nonzeros": sums["almost_nz_mean"] / n,
        "sparsity_ratio": float(sparsity),
    }
