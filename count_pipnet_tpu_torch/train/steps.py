"""The train step, the classifier projection and the eval step's statistics.

Port of count_pipnet_tpu/train/steps.py (reference train.py:8-163,
test.py:67-146). A step takes the phase as a small dict ``sched``:

    lr:      {label: float}, set on the optimizer's groups
    align_w, tanh_w, class_w, pretrain (0/1), finetune (0/1): loss weights
    tau:     Gumbel temperature
    project: 1.0 -> after the step, w <- max(w - 1e-3, 0), multiplier >= 1,
             bias >= 0 (train.py:132-138), outside pretraining and only
             with enforce_weight_sparsity

Trainability is not in ``sched``: the trainer sets ``requires_grad`` per
phase (optim.set_trainable).

In a data-parallel world (``mesh``, parallel/mesh.py) the batch is this
rank's rows of the world's: the loss is the rank's share, the gradients
are summed over the ranks before the optimizer step, and the metrics are
the world's. The step then equals the one-process step on the joined
batch; without a mesh it is that step.
"""

from contextlib import nullcontext

import torch

from ..ops.losses import calculate_loss
from ..parallel.mesh import BatchShard, all_reduce_grads

__all__ = ["train_step", "project_classifier", "eval_stats",
           "autocast_for"]


def autocast_for(device, dtype):
    """``torch.autocast`` to bf16 over a forward when ``dtype`` is
    "bfloat16" (parameters stay f32), else a no-op context."""
    if dtype == "bfloat16":
        return torch.autocast(torch.device(device).type,
                              dtype=torch.bfloat16)
    return nullcontext()


@torch.no_grad()
def project_classifier(model):
    """Sparsity projection after a step (reference train.py:132-138)."""
    clf = model.classification
    clf.weight.sub_(1e-3).clamp_(min=0.0)
    clf.normalization_multiplier.clamp_(min=1.0)
    if clf.bias is not None:
        clf.bias.clamp_(min=0.0)


def train_step(model, optimizer, batch, sched, *, is_count_pipnet=True,
               enforce_weight_sparsity=True, tanh_loss_coeff=1.0,
               class_weights=None, generator=None, dtype="float32",
               noise=None, drop_masks=None, mesh=None):
    """One optimizer step on a two-view batch ``(xs1, xs2, ys)`` (tensors
    on the model's device). ``noise`` / ``drop_masks`` replace the Gumbel
    and stochastic-depth draws from ``generator``. ``mesh``: the
    data-parallel world (``None`` or a mesh that is not distributed: the
    one-process step). Returns the metrics as 0-d tensors (no host
    sync)."""
    if mesh is not None and not mesh.distributed:
        mesh = None
    xs1, xs2, ys = batch
    x = torch.cat([xs1, xs2])
    for group in optimizer.param_groups:
        group["lr"] = sched["lr"][group["label"]]
    optimizer.zero_grad(set_to_none=True)
    with autocast_for(x.device, dtype):
        proto, pooled, out = model(
            x, train=True, tau=sched["tau"], generator=generator,
            noise=noise, drop_masks=drop_masks,
            shard=None if mesh is None else BatchShard(mesh, chunks=2))
    loss, acc, comps = calculate_loss(
        proto.float(), pooled.float(), out.float(), ys,
        sched["align_w"], sched["tanh_w"], sched["class_w"],
        model.classification.normalization_multiplier[0],
        sched["pretrain"], sched["finetune"],
        is_count_pipnet=is_count_pipnet,
        enforce_weight_sparsity=enforce_weight_sparsity,
        tanh_loss_coeff=tanh_loss_coeff, class_weights=class_weights,
        mesh=mesh)
    if loss.requires_grad:
        loss.backward()
    if mesh is not None:
        all_reduce_grads(model.parameters(), mesh)
    optimizer.step()
    if (sched["project"] > 0 and not sched["pretrain"]
            and enforce_weight_sparsity):
        project_classifier(model)
    metrics = {"loss": loss.detach(), "acc": acc.detach(),
               **{k: v.detach() for k, v in comps.items()}}
    return metrics if mesh is None else mesh.sum_values(metrics)


@torch.no_grad()
def eval_stats(model, xs, ys, class_proto_weights, *, num_classes, tau=1.0,
               generator=None, noise=None, dtype="float32"):
    """Per-batch evaluation statistics (the JAX package's eval step):
    predictions, AUC scores, abstentions, local explanation sizes,
    prototypes per class, almost-nonzero counts, top-5 and the confusion
    matrix. ``class_proto_weights`` is the [C, P] virtual weight matrix."""
    with autocast_for(xs.device, dtype):
        _, pooled, out = model(xs, inference=True, train=False, tau=tau,
                               generator=generator, noise=noise)
    out, pooled = out.float(), pooled.float()
    max_out, ys_pred = out.max(dim=1)
    mult = model.classification.normalization_multiplier[0]
    pred_scores = torch.softmax(torch.log1p(out ** mult), dim=1).amax(dim=1)
    scores = pooled[None, :, :] * class_proto_weights[:, None, :]
    relevant = scores.abs() > 1e-3
    any_class_sizes = relevant.any(dim=0).sum(dim=1)
    per_class_counts = relevant.sum(dim=2)                      # [C, B]
    pred_class_sizes = torch.gather(per_class_counts, 0,
                                    ys_pred[None, :])[0]
    prototypes_per_class = ((scores - 1e-3).clamp(min=0.0).mean(dim=1)
                            > 0.0).sum(dim=1).float()
    almost_nz = (pooled.abs() > 1e-3).sum(dim=1)
    k = min(5, num_classes)
    top5 = (out.topk(k, dim=1).indices == ys[:, None]).any(dim=1).float()
    cm = torch.zeros(num_classes, num_classes, dtype=torch.int64,
                     device=out.device)
    cm.index_put_((ys, ys_pred), torch.ones_like(ys), accumulate=True)
    return {
        "ys_pred": ys_pred, "pred_scores": pred_scores,
        "abstained": (max_out == 0).sum(),
        "any_class_sizes_mean": any_class_sizes.float().mean(),
        "pred_class_sizes_mean": pred_class_sizes.float().mean(),
        "prototypes_per_class_mean": prototypes_per_class.mean(),
        "almost_nz_mean": almost_nz.float().mean(),
        "top5_mean": top5.mean(), "cm": cm, "pooled": pooled,
    }
