"""Training a Count-PIPNet with each of the four other intermediates
(``--intermediate_layer linear | linear_full | bilinear | identity``)
against the JAX package:

* six steps of ``train_step`` against ``make_train_step`` for each, across
  the pretrain, finetune and main masks (tests/test_torch_port_
  trajectory.py's helper): losses to 1e-5 relative, frozen tensors
  bit-unchanged, and each final tensor's difference norm within 1 % of
  its move's norm. Not the onehot layer's per-entry bound: the gradients
  agree to ~1e-6 relative at the start, but AdamW's first step moves an
  entry whose gradient is near its eps (1e-8) by a share of the learning
  rate that those last digits decide, so a few entries of some layers
  land a few % of the largest move apart (the norm ratios measured 4e-5
  to 8e-4); and with ``--train_intermediate False``, where the
  intermediate stays bit-unchanged;
* ``label_params`` equal to the JAX package's for each intermediate and
  both ``--train_intermediate`` values, and the optimizer's groups: weight
  decay on ``intermediate``, no group for a frozen one;
* the virtual class-prototype weights (through each intermediate's
  ``classifier_input_weight_matrix``) equal to the JAX package's to 1e-6
  relative;
* an onehot-pretrained state grafted into an identity and a bilinear
  model: the same leaves loaded and kept at fresh init as the JAX
  package's ``_graft``, and its "Partial checkpoint restore" line.
Small widths; inputs from numpy seeds."""

import jax
import numpy as np
import pytest
import torch

from count_pipnet_tpu.train.eval import \
    class_prototype_weights as j_class_prototype_weights
from count_pipnet_tpu.train.optim import label_params as j_label_params
from count_pipnet_tpu.utils.checkpoint import _graft
from count_pipnet_tpu_torch.models.convert import (from_jax_params, jax_path,
                                                   to_jax_params)
from count_pipnet_tpu_torch.models.pipnet import get_count_network
from count_pipnet_tpu_torch.train.eval import class_prototype_weights
from count_pipnet_tpu_torch.train.optim import label_params, make_optimizer
from count_pipnet_tpu_torch.utils.checkpoint import graft_pretrained
from test_torch_port_trajectory import _check_trajectory, _lookup, _models

KINDS = ("linear", "linear_full", "bilinear", "identity")


@pytest.mark.parametrize("kind", KINDS)
def test_intermediate_trajectory_matches_make_train_step(monkeypatch, kind):
    _check_trajectory(monkeypatch, False, *_models(False, intermediate=kind),
                      move_norm=0.01)


def test_frozen_intermediate_stays_unchanged(monkeypatch):
    """``--train_intermediate False`` on the bilinear layer: its W, V and
    embedding never move, on either side, while the rest trains."""
    jm, params, tm = _models(False, intermediate="bilinear")
    init = _check_trajectory(monkeypatch, False, jm, params, tm,
                             train_intermediate=False, move_norm=0.01)
    sd = tm.state_dict()
    names = [k for k in sd if k.startswith("intermediate.")]
    assert names == ["intermediate.embed", "intermediate.W.weight",
                     "intermediate.V.weight"]
    for name in names:
        assert torch.equal(sd[name], init[name]), name
    assert not torch.equal(sd["classification.weight"],
                           init["classification.weight"])


def _meta_model(kind):
    class Args:
        net = "convnext_tiny_26"
        use_mid_layers = True
        num_stages = 3
        num_features = 16
        intermediate_layer = kind

    with torch.device("meta"):  # names and shapes only
        return get_count_network(10, Args, max_count=3)[0]


@pytest.mark.parametrize("train_intermediate", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_label_params_match_jax(kind, train_intermediate):
    model = _meta_model(kind)
    ours = label_params(model, "convnext_tiny_26", True, 3,
                        train_intermediate=train_intermediate)
    tree = {}
    for name in ours:
        path = jax_path(name)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.zeros(1)
    theirs = j_label_params(tree, "convnext_tiny_26", use_mid_layers=True,
                            num_stages=3,
                            train_intermediate=train_intermediate)
    for name, label in ours.items():
        assert _lookup(theirs, jax_path(name)) == label, name
    inter = {lab for n, lab in ours.items() if n.startswith("intermediate.")}
    if kind == "identity":
        assert not inter
    else:
        assert inter == {"intermediate" if train_intermediate else "frozen"}
    groups = {g["label"]: g for g in make_optimizer(
        model, ours, weight_decay=0.05).param_groups}
    assert ("intermediate" in groups) == (bool(inter)
                                          and train_intermediate)
    if "intermediate" in groups:
        assert groups["intermediate"]["weight_decay"] == 0.05
    assert groups["cls_weight"]["weight_decay"] == 0.05
    assert groups["add_on"]["weight_decay"] == 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_class_prototype_weights_match_jax(kind):
    """Random intermediate parameters (not the structured init), so each
    layer's attribution matrix shows."""
    jm, params, tm = _models(False, intermediate=kind)
    rng = np.random.default_rng(3)
    inter = jax.tree_util.tree_map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32),
        params.get("intermediate", {}))
    params = dict(params, intermediate=inter) if inter else params
    tm.load_state_dict(from_jax_params(params))
    want = np.asarray(j_class_prototype_weights(jm, params))
    got = class_prototype_weights(tm).numpy()
    assert got.shape == want.shape == (tm.num_classes, tm.num_prototypes)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["identity", "bilinear"])
def test_onehot_pretrained_graft_matches_jax(kind, capsys):
    """The onehot model's state grafted into ``kind``: identity's
    classifier is [C, P], not [C, P * M], and bilinear's W, V and
    embedding are not in the onehot state, so those keep the fresh init;
    the rest equals the onehot state. Counts and values as _graft's."""
    _, onehot, tm_onehot = _models(False)
    _, fresh, tm = _models(False, intermediate=kind)
    # a fresh model whose shared leaves differ from the onehot state
    fresh = jax.tree_util.tree_map(lambda a: np.asarray(a) + 1.0, fresh)
    tm.load_state_dict(from_jax_params(fresh))
    want, loaded_j, skipped_j = _graft(fresh, onehot)
    loaded, skipped = graft_pretrained(tm, tm_onehot.state_dict())
    assert (loaded, skipped) == (loaded_j, skipped_j)
    assert skipped == (1 if kind == "identity" else 3)
    assert (f"Partial checkpoint restore: {loaded} leaves loaded, "
            f"{skipped} kept at fresh init") in capsys.readouterr().out
    got = to_jax_params(tm.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        names = tuple(k.key for k in path)
        np.testing.assert_array_equal(_lookup(got, names), np.asarray(leaf),
                                      err_msg=str(names))
