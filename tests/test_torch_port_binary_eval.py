"""The binary-task metrics of the port's ``evaluate`` (two classes):

* ``balanced_accuracy`` and ``binary_auc`` (numpy; the card's machine has
  no sklearn) against sklearn's ``balanced_accuracy_score`` and
  ``roc_auc_score`` on random labels, predictions and scores with many
  ties, to 1e-12; one-class labels: no AUC (sklearn raises or, from
  1.8, returns NaN);
* ``evaluate`` on a 2-class PIP-Net against the JAX package's
  ``evaluate`` (sklearn here) on the same parameters and batches: the
  same keys (sensitivity, specificity, balanced_accuracy, auc_macro,
  auc_weighted), values to 1e-6, and the same printouts; on a test set
  with duplicated images (tied scores across the classes) and on a
  one-class test set, where balanced accuracy is present and both AUC
  keys are absent (the JAX package's are absent with an sklearn that
  raises there, NaN with one that does not); and ``evaluate_model_lightweight`` against the JAX
  package's.
Small widths; inputs from numpy seeds."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from sklearn.metrics import balanced_accuracy_score, roc_auc_score

from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu.models.pipnet import PIPNet as JPIPNet
from count_pipnet_tpu.train import eval as jeval
from count_pipnet_tpu_torch.models.convert import from_jax_params
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.pipnet import PIPNet
from count_pipnet_tpu_torch.train.eval import (balanced_accuracy, binary_auc,
                                               evaluate,
                                               evaluate_model_lightweight)
from test_torch_port_trajectory import NUM_STAGES, P, STAGES

BINARY_KEYS = ("sensitivity", "specificity", "balanced_accuracy",
               "auc_macro", "auc_weighted")


@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 40))
        y = rng.integers(0, 2, n)
        pred = rng.integers(0, 2, n)
        scores = rng.integers(0, 4, n) / 3.0 if seed % 2 else rng.random(n)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = balanced_accuracy_score(y, pred)
        assert abs(balanced_accuracy(y, pred) - want) < 1e-12
        want = _sklearn_auc(y, scores)
        if len(np.unique(y)) == 2:
            assert abs(binary_auc(y, scores) - want) < 1e-12
        else:
            assert binary_auc(y, scores) is None and want is None


def _sklearn_auc(y, scores):
    """roc_auc_score, None where it is undefined: one class in ``y``,
    where sklearn raises (before 1.8) or warns and returns NaN."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            auc = roc_auc_score(y, scores)
    except ValueError:
        return None
    return None if np.isnan(auc) else auc


def _pair():
    jm = JPIPNet(num_classes=2, num_prototypes=P,
                 backbone=JFeatures(stage_settings=STAGES,
                                    stride_threshold=40,
                                    num_stages=NUM_STAGES),
                 num_features=P)
    params = jax.device_get(jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(6), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)))["params"])
    rng = np.random.default_rng(6)
    bb = {k: (dict(v, layer_scale=np.full_like(v["layer_scale"], 0.2))
              if "layer_scale" in v else v)
          for k, v in params["backbone"].items()}
    params = dict(params, backbone=bb, classification={
        "weight": (1.0 + 0.3 * rng.normal(size=(2, P))).astype(np.float32),
        "multiplier": np.full((1,), 2.0, np.float32)})
    tm = PIPNet(num_classes=2, num_prototypes=P,
                backbone=ConvNeXtFeatures(STAGES, 40, NUM_STAGES),
                num_features=P)
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm


def _loader(case):
    """Two batches of 6; with ``ties`` each batch repeats its first two
    images under the other label; ``one_class``: every label 0."""
    rng = np.random.default_rng(10)
    out = []
    for _ in range(2):
        xs = rng.normal(size=(6, 64, 64, 3)).astype(np.float32)
        ys = rng.integers(0, 2, 6).astype(np.int32)
        if case == "ties":
            xs[4:], ys[4:] = xs[:2], 1 - ys[:2]
        else:
            ys[:] = 0
        out.append((xs, ys))
    return out


@pytest.mark.parametrize("case", ["ties", "one_class"])
def test_binary_evaluate_matches_jax(case, capsys):
    jm, params, tm = _pair()
    loader = _loader(case)
    info_j, shrunk = jeval.evaluate(jm, params, {}, loader, 1,
                                    num_classes=2, rng=jax.random.PRNGKey(0))
    out_j = capsys.readouterr().out
    info_t = evaluate(tm, loader, 1, num_classes=2)
    out_t = capsys.readouterr().out
    # an undefined AUC: the JAX package's sklearn call raises (sklearn
    # before 1.8; the key stays absent) or returns NaN (the key present)
    keys_j = [k for k in BINARY_KEYS
              if k in info_j and not np.isnan(info_j[k])]
    assert [k for k in BINARY_KEYS if k in info_t] == keys_j
    if case == "one_class":
        assert keys_j == ["sensitivity", "specificity", "balanced_accuracy"]
    else:
        assert keys_j == list(BINARY_KEYS)
        assert 0.0 < info_t["auc_macro"] < 1.0
    np.testing.assert_array_equal(info_t["confusion_matrix"],
                                  info_j["confusion_matrix"])
    for k in keys_j:
        np.testing.assert_allclose(info_t[k], info_j[k], rtol=1e-6,
                                   err_msg=k)
    for line in ("TP:", "Confusion matrix:", "Balanced accuracy:",
                 "Sensitivity:") + (("AUC macro:",) if case == "ties"
                                    else ()):
        assert line in out_t and line in out_j, line
    assert ("AUC macro:" in out_t) == (case == "ties")
    # after the weight shrink of both passes, without a shrink of its own
    light_j = jeval.evaluate_model_lightweight(jm, shrunk, {}, loader,
                                               num_classes=2)
    light = evaluate_model_lightweight(tm, loader, num_classes=2)
    np.testing.assert_array_equal(light["confusion_matrix"],
                                  light_j["confusion_matrix"])
    assert light["accuracy"] == light_j["accuracy"]
    assert light["num_classes"] == 2
