"""Test-set evaluation.

Port of count_pipnet_tpu/train/eval.py (reference pipnet/test.py:12-185).
The per-batch statistics are train/steps.py:eval_stats; this module owns
the loop, the virtual weights, and the reference's destructive weight
shrink: before every batch the live classifier weight becomes
``max(w - 1e-3, 0)`` (test.py:71-73), in place, so it carries into
training as in the reference.

With two classes it adds the binary-task metrics of the JAX package
(its train/eval.py:144-168, reference test.py:159-183), computed in numpy
as sklearn computes them: sensitivity and specificity with class 0 as the
positive one, balanced accuracy (the mean recall over the classes that
occur in the labels) and the AUC (the rank statistic, ties counted one
half; macro and weighted are one number for binary labels). As there,
the AUC scores are ``pred_scores``, the largest softmax of
``log1p(out ** multiplier)``, not the probability of class 1, and a
one-class test set has a balanced accuracy but no AUC keys.
"""

import numpy as np
import torch

from ..models.pipnet import CountPIPNet, importance_per_class
from .steps import eval_stats

__all__ = ["evaluate", "evaluate_model_lightweight",
           "class_prototype_weights", "acc_from_cm", "balanced_accuracy",
           "binary_auc"]


def acc_from_cm(cm: np.ndarray) -> float:
    """Accuracy from a confusion matrix (reference test.py:248-264)."""
    total = cm.sum()
    return float(np.trace(cm) / total) if total > 0 else 1.0


def balanced_accuracy(y_true, y_pred) -> float:
    """sklearn's ``balanced_accuracy_score``: the mean over the classes in
    ``y_true`` of the share of their samples predicted as themselves."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    recalls = [np.mean(y_pred[y_true == c] == c) for c in np.unique(y_true)]
    return float(np.mean(recalls))


def binary_auc(y_true, scores):
    """sklearn's ``roc_auc_score`` for binary labels (the larger label
    positive): the probability that a positive outscores a negative, ties
    one half, from the average ranks. None when ``y_true`` holds one class
    (where the score is undefined)."""
    y_true, scores = np.asarray(y_true), np.asarray(scores, np.float64)
    classes = np.unique(y_true)
    if len(classes) != 2:
        return None
    pos = y_true == classes[1]
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores))
    sorted_scores = scores[order]
    # average rank (1-based) of each run of equal scores
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_scores)) + 1]
    ends = np.r_[starts[1:], len(scores)]
    for a, b in zip(starts, ends):
        ranks[order[a:b]] = (a + b + 1) / 2.0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


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
    y_trues, y_scores, y_pred_classes = [], [], []
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
        if num_classes == 2:
            y_trues.extend(ys.tolist())
            y_scores.extend(stats["pred_scores"].tolist())
            y_pred_classes.extend(stats["ys_pred"].tolist())
    print(f"PIP-Net abstained from a decision for {abstained} images",
          flush=True)
    w = model.classification.weight.detach().cpu().numpy()
    num_nonzero = int((cpw.cpu().numpy() > 1e-3).any(axis=0).sum())
    sparsity = (w.size - np.count_nonzero(np.maximum(w - 1e-3, 0))) / w.size
    print("sparsity ratio:", sparsity, flush=True)
    n = max(n_images, 1)
    info = {
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
    if num_classes == 2:
        info.update(_binary_metrics(cm, y_trues, y_scores, y_pred_classes))
    return info


def _binary_metrics(cm, y_trues, y_scores, y_pred_classes):
    """The JAX package's binary-task block, printouts included."""
    tp, fn = cm[0][0], cm[0][1]
    fp, tn = cm[1][0], cm[1][1]
    print("TP:", tp, "FN:", fn, "FP:", fp, "TN:", tn, flush=True)
    sensitivity = tp / (tp + fn) if (tp + fn) else 0.0
    specificity = tn / (tn + fp) if (tn + fp) else 0.0
    out = {"sensitivity": sensitivity, "specificity": specificity}
    print("Confusion matrix:", cm, flush=True)
    if y_trues:
        out["balanced_accuracy"] = balanced_accuracy(y_trues, y_pred_classes)
        print("Balanced accuracy:", out["balanced_accuracy"], flush=True)
        auc = binary_auc(y_trues, y_scores)
        if auc is not None:
            out["auc_macro"] = out["auc_weighted"] = auc
            print("AUC macro:", auc, flush=True)
    print("Sensitivity:", sensitivity, "Specificity:", specificity,
          flush=True)
    return out


def evaluate_model_lightweight(model, loader, *, num_classes,
                               generator=None, tau=1.0, dtype="float32"):
    """Accuracy and confusion matrix only, without the weight shrink (the
    JAX package's train/eval.py:173-181, reference test.py:187-246)."""
    info = evaluate(model, loader, "light", num_classes=num_classes,
                    enforce_weight_sparsity=False, generator=generator,
                    tau=tau, dtype=dtype)
    return {"accuracy": info["test_accuracy"],
            "confusion_matrix": info["confusion_matrix"],
            "num_classes": num_classes}
