"""Saliency attribution: IG / LeftIG, IDG, Guided IG, SmoothGrad.

Port of count_pipnet_tpu/interpret/saliency.py (reference
util/saliency_methods.py:6-238, util/GIGBuilder.py):

* IG with an ``alpha_star`` early cutoff (LeftIG): integrate only up to
  the first step whose score exceeds alpha_star * the largest score;
* Integrated Directional Gradients: a pilot pass measures the score's
  slopes along the straight path, the alpha samples are re-placed in
  proportion to the normalized slopes, and the integral weights the
  gradients by slope and by the non-uniform spacing;
* Guided IG's adaptive path (move the features of smallest |gradient|
  first), SmoothGrad and the grayscale / diverging visualisers.

As in the JAX package the host orchestrates in numpy (the alphas, the
slope placement, Guided IG's quantiles): only the score and its input
gradient run on the device, one batch of interpolated NHWC images a call
(:func:`make_score_grad_fn`). The gradient is ``torch.autograd.grad`` of
the summed scores with respect to the batch alone, so a model's
parameters keep their ``.grad``. ``device`` says where the batches go.
"""

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["IG", "IDG", "guided_ig", "smoothgrad", "make_score_grad_fn",
           "visualize_grayscale", "visualize_diverging"]


def make_score_grad_fn(model_fn: Callable):
    """(inputs [B,H,W,C] tensor -> grads [B,H,W,C], scores [B]) for a
    scalar-score model ``model_fn(x) -> [B]``, on the inputs' device."""

    def score_and_grad(xs):
        xs = xs.detach().requires_grad_(True)
        with torch.enable_grad():
            scores = model_fn(xs)
            grads, = torch.autograd.grad(scores.sum(), xs)
        return grads, scores.detach()

    return score_and_grad


def _as_baseline(input_arr, baseline):
    if isinstance(baseline, (int, float)):
        return np.full_like(input_arr, float(baseline))
    return np.asarray(baseline, dtype=input_arr.dtype)


def _score_fn(model_fn, target_class):
    return (model_fn if target_class is None
            else (lambda x: model_fn(x)[:, target_class]))


def _host_call(sag, xs, device):
    """One score-and-gradient call on ``device``: (grads, scores) in
    numpy."""
    g, sc = sag(torch.as_tensor(xs, dtype=torch.float32, device=device))
    return g.cpu().numpy(), sc.float().cpu().numpy()


def IG(input_arr, model_fn, steps=128, batch_size=32, alpha_star=1.0,
       baseline=0.0, target_class: Optional[int] = None, device="cuda"):
    """(Left-)Integrated Gradients.

    Args:
      input_arr: [1, H, W, C] normalized image.
      model_fn: callable [B,H,W,C] tensor -> [B, num_classes] logits, or
        [B] scores when target_class is None.
      alpha_star: 1.0 = plain IG; < 1.0 integrates only up to the first
        step whose score exceeds alpha_star * the largest score (LeftIG).

    Returns attribution [H, W, C].
    """
    assert steps % batch_size == 0, "steps must divide by batch_size"
    input_arr = np.asarray(input_arr, np.float32)
    base = _as_baseline(input_arr, baseline)
    diff = input_arr - base
    sag = make_score_grad_fn(_score_fn(model_fn, target_class))

    alphas = np.linspace(0.0, 1.0, steps, dtype=np.float32)
    grads = np.zeros((steps,) + input_arr.shape[1:], np.float32)
    logits = np.zeros(steps, np.float32)
    for s in range(0, steps, batch_size):
        a = alphas[s:s + batch_size].reshape(-1, 1, 1, 1)
        g, sc = _host_call(sag, base + a * diff, device)
        grads[s:s + batch_size] = g
        logits[s:s + batch_size] = sc

    if alpha_star >= 1.0:
        mean_grad = grads.mean(axis=0)
    else:
        cutoff = logits.max() * alpha_star
        above = np.where(logits > cutoff)[0]
        cutoff_step = int(above[0]) if above.size else 1
        cutoff_step = max(cutoff_step, 1)
        mean_grad = grads[:cutoff_step].mean(axis=0)

    return (mean_grad * diff[0])


def _alpha_parameters(slopes, steps, step_size):
    """Slope-proportional sample placement
    (reference saliency_methods.py:188-238)."""
    slopes = np.asarray(slopes, np.float64)
    rng_span = slopes.max() - slopes.min()
    norm = (slopes - slopes.min()) / (rng_span if rng_span > 0 else 1.0)
    norm[0] = 0.0
    total = norm.sum()
    norm = norm / (total if total > 0 else 1.0)

    placements_float = norm * steps
    placements_int = placements_float.astype(np.int64)
    remaining = steps - placements_int.sum()

    marker = placements_float.copy()
    marker[placements_int != 0] = -1.0
    order_hi_lo = np.argsort(marker)[::-1]
    placements_int[order_hi_lo[:remaining]] = 1

    alphas = np.zeros(steps, np.float64)
    substeps = np.zeros(steps, np.float64)
    idx, start_val = 0, 0.0
    for n in placements_int:
        if n == 0:
            start_val += step_size
            continue
        seg = np.linspace(start_val, start_val + step_size, n + 1)[:n]
        alphas[idx:idx + n] = seg
        substeps[idx:idx + n] = step_size / n
        idx += n
        start_val += step_size
    return alphas.astype(np.float32), substeps.astype(np.float32)


def IDG(input_arr, model_fn, steps=128, batch_size=32, baseline=0.0,
        target_class: Optional[int] = None, device="cuda"):
    """Integrated Directional Gradients
    (reference saliency_methods.py:68-130)."""
    assert batch_size > 0 and steps % batch_size == 0
    input_arr = np.asarray(input_arr, np.float32)
    base = _as_baseline(input_arr, baseline)
    diff = input_arr - base
    sag = make_score_grad_fn(_score_fn(model_fn, target_class))

    # pilot: scores along the uniform path -> slopes
    uni = np.linspace(0.0, 1.0, steps, dtype=np.float32)
    step_size = float(uni[1] - uni[0])
    logits = np.zeros(steps, np.float32)
    for s in range(0, steps, batch_size):
        a = uni[s:s + batch_size].reshape(-1, 1, 1, 1)
        _, sc = _host_call(sag, base + a * diff, device)
        logits[s:s + batch_size] = sc
    slopes = np.zeros(steps, np.float32)
    slopes[1:] = (logits[1:] - logits[:-1]) / step_size

    alphas, substeps = _alpha_parameters(slopes, steps, step_size)

    grads = np.zeros((steps,) + input_arr.shape[1:], np.float32)
    logits2 = np.zeros(steps, np.float32)
    for s in range(0, steps, batch_size):
        a = alphas[s:s + batch_size].reshape(-1, 1, 1, 1)
        g, sc = _host_call(sag, base + a * diff, device)
        grads[s:s + batch_size] = g
        logits2[s:s + batch_size] = sc

    slopes2 = np.zeros(steps, np.float32)
    denom = np.diff(alphas)
    denom[denom == 0] = np.inf
    slopes2[1:] = (logits2[1:] - logits2[:-1]) / denom

    weighted = grads * slopes2.reshape(-1, 1, 1, 1) \
        * substeps.reshape(-1, 1, 1, 1)
    return weighted.mean(axis=0) * diff[0]


def guided_ig(input_arr, model_fn, steps=128, fraction=0.25,
              max_dist=0.02, baseline=0.0,
              target_class: Optional[int] = None, device="cuda"):
    """Guided Integrated Gradients: adaptive path moving the lowest-|grad|
    features first (reference util/GIGBuilder.py:194-310, vendored from
    PAIR-code saliency). A host loop of batch-1 gradients."""
    input_arr = np.asarray(input_arr, np.float32)
    base = _as_baseline(input_arr, baseline)
    x_input = input_arr[0]
    x_base = base[0]
    sag = make_score_grad_fn(_score_fn(model_fn, target_class))

    def grad_of(x):
        g, _ = _host_call(sag, x[None], device)
        return g[0]

    attr = np.zeros_like(x_input)
    x = x_base.copy()
    l1_total = np.abs(x_input - x_base).sum()
    if l1_total == 0:
        return attr

    eps = 1e-12
    for step in range(steps):
        alpha = (step + 1.0) / steps
        l1_target = l1_total * (1 - alpha)
        gamma = np.inf
        while gamma > 1.0:
            x_old = x.copy()
            l1_current = np.abs(x_input - x).sum()
            if l1_current == 0 or abs(l1_current - l1_target) < eps:
                break
            grad_actual = grad_of(x)
            grad = grad_actual.copy()
            done_mask = np.abs(x_input - x) <= eps
            grad[done_mask] = np.inf
            # threshold = |grad| quantile among unfinished features
            finite = np.abs(grad[~done_mask])
            if finite.size == 0:
                break
            threshold = np.quantile(finite, fraction, method="lower")
            sel = (np.abs(grad) <= threshold) & ~np.isinf(grad)
            l1_sel = np.abs(x_input - x)[sel].sum()
            if l1_sel == 0:
                break
            gamma = (l1_current - l1_target) / l1_sel
            if gamma > 1.0:
                x[sel] = x_input[sel]
            else:
                x[sel] = x[sel] + gamma * (x_input[sel] - x[sel])
            attr += (x - x_old) * grad_actual
    return attr


def smoothgrad(attr_fn, input_arr, n_samples=8, stdev_spread=0.15,
               magnitude=True, seed=0):
    """SmoothGrad wrapper (reference GIGBuilder.py:39-111): average the
    attribution over gaussian-perturbed inputs."""
    input_arr = np.asarray(input_arr, np.float32)
    stdev = stdev_spread * (input_arr.max() - input_arr.min())
    rng = np.random.default_rng(seed)
    total = np.zeros(input_arr.shape[1:], np.float32)
    for _ in range(n_samples):
        noise = rng.normal(0, stdev, input_arr.shape).astype(np.float32)
        a = attr_fn(input_arr + noise)
        total += a * a if magnitude else a
    return total / n_samples


def visualize_grayscale(attr, percentile=99):
    """2D grayscale visualization in [0,1]
    (reference GIGBuilder.py:137-150)."""
    flat = np.abs(attr).sum(axis=-1)
    vmax = np.percentile(flat, percentile)
    vmin = flat.min()
    return np.clip((flat - vmin) / (vmax - vmin + 1e-12), 0, 1)


def visualize_diverging(attr, percentile=99):
    """Signed diverging visualization in [-1,1]
    (reference GIGBuilder.py:152-162)."""
    flat = attr.sum(axis=-1)
    span = np.percentile(np.abs(flat), percentile)
    return np.clip(flat / (span + 1e-12), -1, 1)
