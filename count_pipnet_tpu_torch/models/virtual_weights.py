"""Virtual weights of Count-PIPNet for interpretability.

Port of count_pipnet_tpu/models/virtual_weights.py (reference
pipnet/count_pipnet.py:226-321): the dataset-mean intermediate features of
the clamped counts, and the virtual [num_classes, num_prototypes]
classification matrix, optionally scaled by those means
(``custom_onehot_scale``).
"""

import torch

from .pipnet import CountPIPNet, importance_per_class

__all__ = ["estimate_mean_intermediate_features", "calculate_virtual_weights"]


@torch.no_grad()
def estimate_mean_intermediate_features(model: CountPIPNet, loader, *,
                                        tau=1.0, generator=None,
                                        return_full_data=False):
    """Mean intermediate features over a loader's clamped counts
    ([intermediate_dim]); with ``return_full_data``, (features [N, D],
    labels [N])."""
    device = model.classification.weight.device
    feats, labels = [], []
    for item in loader:
        xs, ys = item[0], item[-1]
        xs = torch.as_tensor(xs, dtype=torch.float32, device=device)
        _, clamped, _ = model(xs, inference=True, tau=tau,
                              generator=generator)
        feats.append(model.intermediate(clamped.float()))
        labels.append(torch.as_tensor(ys, dtype=torch.int64))
    features = (torch.cat(feats) if feats else
                torch.zeros(0, model.intermediate.output_dim, device=device))
    if return_full_data:
        return features, torch.cat(labels) if labels else torch.zeros(0)
    return features.mean(dim=0)


def calculate_virtual_weights(model: CountPIPNet, loader=None, *,
                              custom_onehot_scale=False, tau=1.0,
                              generator=None):
    """Virtual [num_classes, num_prototypes] classification matrix."""
    scalars = None
    if model.intermediate_type == "onehot" and custom_onehot_scale:
        if loader is None:
            raise ValueError("custom_onehot_scale requires a dataloader")
        scalars = estimate_mean_intermediate_features(
            model, loader, tau=tau, generator=generator)
    return importance_per_class(model, classifier_input_scalars=scalars)
