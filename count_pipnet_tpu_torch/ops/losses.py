"""Loss functions of PIP-Net / Count-PIPNet training.

Port of count_pipnet_tpu/ops/losses.py (reference pipnet/train.py:165-265).
Phase logic (pretrain / finetune) enters as float weights, as in the JAX
package. Prototype maps are NHWC ([B, H, W, P]), so the align loss's
patch flattening is a reshape.

In a data-parallel world (``mesh``, parallel/mesh.py) each rank computes
its share of the joined batch's loss: the shares sum over the ranks to the
one-process loss, in value and gradient. The align loss and the plain
class loss are means over equal slices (share: the rank's mean / R); the
tanh loss and the weighted class loss couple the batch through sums
(share: the world's value / R, the sums read through the all-reduce).
"""

import torch

__all__ = ["align_loss", "tanh_loss", "class_loss", "calculate_loss"]


def align_loss(inputs, targets, eps=1e-12):
    """-log(<z1, z2>) over patch embeddings [N, P]; pass ``targets``
    detached (reference train.py:259-265)."""
    return -torch.log((inputs * targets).sum(dim=-1) + eps).mean()


def _local(x):
    return x


def tanh_loss(pooled1, pooled2, coeff=1.0, eps=1e-8, batch_sum=_local):
    """Every prototype should fire somewhere in the batch
    (reference train.py:194-195). ``batch_sum`` maps the rank's sums over
    the batch to the world's (``Mesh.all_reduce``)."""
    sums = batch_sum(torch.stack([(coeff * pooled1).sum(dim=0),
                                  (coeff * pooled2).sum(dim=0)]))
    t1 = torch.log(torch.tanh(sums[0]) + eps).mean()
    t2 = torch.log(torch.tanh(sums[1]) + eps).mean()
    return -(t1 + t2) / 2.0


def class_loss(out, ys, normalization_multiplier, enforce_weight_sparsity=True,
               class_weights=None, batch_sum=_local):
    """NLL over log_softmax(log1p(out ** multiplier))
    (reference train.py:210-216); with ``class_weights`` the weighted mean
    sum(w nll) / sum(w), its two sums through ``batch_sum``."""
    if enforce_weight_sparsity:
        softmax_inputs = torch.log1p(out ** normalization_multiplier)
    else:
        softmax_inputs = out
    logp = torch.log_softmax(softmax_inputs, dim=1)
    nll = -torch.gather(logp, 1, ys[:, None])[:, 0]
    if class_weights is not None:
        w = class_weights[ys]
        sums = batch_sum(torch.stack([(w * nll).sum(), w.sum()]))
        return sums[0] / sums[1]
    return nll.mean()


def calculate_loss(proto_features, pooled, out, ys1, align_pf_weight,
                   t_weight, cl_weight, normalization_multiplier, pretrain_w,
                   finetune_w, is_count_pipnet=False, eps=1e-8,
                   enforce_weight_sparsity=True, tanh_loss_coeff=1.0,
                   class_weights=None, mesh=None):
    """Combined loss over a two-view batch (views concatenated along the
    batch; ``ys1`` holds one view's labels). Returns (loss, acc,
    components) like the JAX package's ``calculate_loss``; with ``mesh``
    (a data-parallel world) each of them is this rank's share (see the
    module docstring)."""
    world = mesh is not None
    batch_sum = mesh.all_reduce if world else _local
    pf1, pf2 = torch.chunk(proto_features, 2, dim=0)
    pooled1, pooled2 = torch.chunk(pooled, 2, dim=0)
    ys = torch.cat([ys1, ys1])
    p = proto_features.shape[-1]
    embv1 = pf1.reshape(-1, p)
    embv2 = pf2.reshape(-1, p)
    a_loss = (align_loss(embv1, embv2.detach())
              + align_loss(embv2, embv1.detach())) / 2.0
    coeff = tanh_loss_coeff if is_count_pipnet else 1.0
    t_loss = tanh_loss(pooled1, pooled2, coeff=coeff, eps=eps,
                       batch_sum=batch_sum)
    c_loss = class_loss(out, ys, normalization_multiplier,
                        enforce_weight_sparsity=enforce_weight_sparsity,
                        class_weights=class_weights, batch_sum=batch_sum)
    acc = (out.argmax(dim=1) == ys).float().mean()
    if world:  # shares: Σ_r over the ranks gives the joined batch's value
        r = float(mesh.size)
        a_loss, t_loss, c_loss, acc = (a_loss / r, t_loss / r, c_loss / r,
                                       acc / r)
    not_finetune = 1.0 - finetune_w
    not_pretrain = 1.0 - pretrain_w
    loss = not_finetune * (align_pf_weight * a_loss + t_weight * t_loss)
    loss = loss + not_pretrain * cl_weight * c_loss
    acc = acc * not_pretrain
    components = {
        "align": a_loss,
        "align_weighted": a_loss * align_pf_weight,
        "tanh": t_loss,
        "tanh_weighted": t_loss * t_weight,
        "class": c_loss * not_pretrain,
        "class_weighted": c_loss * cl_weight * not_pretrain,
    }
    return loss, acc, components
