"""Multi-run comparison analysis.

The port's copy of notebooks/interp_many.py (reference
notebooks/interp_many.py): loads several trained runs, runs the per-run
interpretation pipeline (run_analysis_pipeline :182) and renders a
combined prototype-importance scatter across runs (:165). The reference
renders these as interactive plotly figures; without plotly or a
network, alongside the static PNGs an interactive
self-contained HTML comparator (``runs_compare.html``) embeds every run's
global-explanation matrix with vanilla-JS hoverable heatmaps and a
combined importance scatter with hover + run toggling.

Usage:
    python -m count_pipnet_tpu_torch.notebooks.interp_many \
        --run_dirs runA runB ... \
        [--out_dir ./analysis]
"""

import argparse
import os

import numpy as np

from .main_interp import (calculate_global_explanation,
                          show_global_explanation)


def run_analysis_pipeline(run_dirs, out_dir, checkpoint="net_best"):
    """Per-run global explanations + cross-run importance comparison
    (reference notebooks/interp_many.py:182)."""
    os.makedirs(out_dir, exist_ok=True)
    explanations = {}
    for run_dir in run_dirs:
        name = os.path.basename(os.path.normpath(run_dir))
        try:
            expl = calculate_global_explanation(run_dir, checkpoint)
        except Exception as e:
            print(f"skipping {run_dir}: {e}")
            continue
        explanations[name] = expl
        show_global_explanation(
            expl, os.path.join(out_dir, f"{name}_global.png"))

    if len(explanations) >= 2:
        combined_importance_scatter(explanations, out_dir)
    if explanations:
        build_comparison_html(explanations, out_dir)
    summary_table(explanations, out_dir)
    return explanations


def combined_importance_scatter(explanations, out_dir):
    """Prototype total importance per run, overlaid
    (reference interp_many.py:165)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    for name, expl in explanations.items():
        imp = expl["weights"].sum(axis=0)   # total importance per prototype
        ax.scatter(range(len(imp)), np.sort(imp)[::-1], s=14, label=name,
                   alpha=0.7)
    ax.set_xlabel("Prototype rank")
    ax.set_ylabel("Total importance")
    ax.set_yscale("symlog", linthresh=1e-3)
    ax.legend(fontsize=7)
    fig.tight_layout()
    path = os.path.join(out_dir, "combined_importance_scatter.png")
    fig.savefig(path, dpi=130)
    plt.close(fig)
    print(f"Combined importance scatter: {path}")


_COMPARE_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Run comparison</title>
<style>
 body { font-family: sans-serif; margin: 16px; background: #fafafa; }
 .runbox { display: inline-block; margin: 0 16px 16px 0;
           vertical-align: top; }
 canvas { border: 1px solid #888; image-rendering: pixelated; }
 #tip { position: fixed; background: #222; color: #fff; padding: 4px 8px;
        border-radius: 4px; font-size: 12px; pointer-events: none;
        display: none; z-index: 10; }
 .runlabel { font-size: 13px; font-weight: bold; margin-bottom: 2px; }
 label { font-size: 13px; margin-right: 10px; }
</style></head><body>
<h2>Cross-run global explanations</h2>
<div id="tip"></div>
<h3>Combined prototype importance (hover a point; toggle runs)</h3>
<div id="toggles"></div>
<canvas id="scatter" width="760" height="300"></canvas>
<h3>Per-run class &times; prototype heatmaps (hover for values)</h3>
<div id="heatmaps"></div>
<script>
const RUNS = __RUNS__;
const names = Object.keys(RUNS);
const palette = ['#e03030','#1f77d0','#0f9d58','#f4a000','#8040c0',
                 '#00897b','#c2185b','#5d4037'];
const tip = document.getElementById('tip');
function showTip(e, text) {
  tip.style.display = 'block';
  tip.style.left = (e.clientX + 12) + 'px';
  tip.style.top = (e.clientY + 12) + 'px';
  tip.textContent = text;
}
// ---- combined importance scatter: per-run sorted total importance ----
const enabled = {};
names.forEach(n => enabled[n] = true);
const sc = document.getElementById('scatter');
const sctx = sc.getContext('2d');
const pts = [];  // {x, y, run, proto, v}
function drawScatter() {
  sctx.clearRect(0, 0, sc.width, sc.height);
  pts.length = 0;
  let pmax = 0, vmax = 0;
  for (const n of names) {
    if (!enabled[n]) continue;
    const W = RUNS[n].W, P = W[0].length;
    pmax = Math.max(pmax, P);
    for (let p = 0; p < P; p++) {
      let s = 0;
      for (const row of W) s += row[p];
      vmax = Math.max(vmax, s);
    }
  }
  if (!pmax) return;
  names.forEach((n, ri) => {
    if (!enabled[n]) return;
    const W = RUNS[n].W, P = W[0].length;
    const totals = [];
    for (let p = 0; p < P; p++) {
      let s = 0;
      for (const row of W) s += row[p];
      totals.push([p, s]);
    }
    totals.sort((a, b) => b[1] - a[1]);
    totals.forEach(([p, v], rank) => {
      const x = 40 + (sc.width - 60) * rank / Math.max(1, pmax - 1);
      const y = sc.height - 24 -
          (sc.height - 44) * (vmax > 0 ? v / vmax : 0);
      sctx.fillStyle = palette[ri % palette.length];
      sctx.beginPath(); sctx.arc(x, y, 4, 0, 7); sctx.fill();
      pts.push({x, y, run: n, proto: p, v});
    });
  });
  sctx.fillStyle = '#444'; sctx.font = '11px sans-serif';
  sctx.fillText('prototype rank \\u2192', sc.width - 110, sc.height - 6);
  sctx.save(); sctx.rotate(-Math.PI / 2);
  sctx.fillText('total importance', -150, 12); sctx.restore();
}
sc.addEventListener('mousemove', e => {
  const r = sc.getBoundingClientRect();
  const mx = e.clientX - r.left, my = e.clientY - r.top;
  const hit = pts.find(q => (q.x - mx) ** 2 + (q.y - my) ** 2 < 30);
  if (hit) showTip(e, `${hit.run} P${hit.proto}: ${hit.v.toFixed(3)}`);
  else tip.style.display = 'none';
});
sc.addEventListener('mouseleave', () => tip.style.display = 'none');
const tg = document.getElementById('toggles');
names.forEach((n, ri) => {
  const l = document.createElement('label');
  l.innerHTML = `<input type="checkbox" checked> <span style="color:` +
      `${palette[ri % palette.length]}">\\u25cf</span> ${n}`;
  l.querySelector('input').addEventListener('change', ev => {
    enabled[n] = ev.target.checked; drawScatter();
  });
  tg.appendChild(l);
});
drawScatter();
// ---- per-run heatmaps ----
const hmdiv = document.getElementById('heatmaps');
for (const n of names) {
  const W = RUNS[n].W, classes = RUNS[n].classes;
  const C = W.length, P = W[0].length;
  const cell = Math.max(3, Math.min(14, Math.floor(420 / P)));
  const box = document.createElement('div');
  box.className = 'runbox';
  box.innerHTML = `<div class="runlabel">${n} (${C}\\u00d7${P})</div>`;
  const cv = document.createElement('canvas');
  cv.width = P * cell; cv.height = C * cell;
  box.appendChild(cv); hmdiv.appendChild(box);
  const ctx = cv.getContext('2d');
  let wmax = 0;
  for (const row of W) for (const v of row) wmax = Math.max(wmax, v);
  for (let c = 0; c < C; c++) for (let p = 0; p < P; p++) {
    const t = wmax > 0 ? W[c][p] / wmax : 0;
    ctx.fillStyle = `rgb(${Math.round(20 + 235 * t)},` +
        `${Math.round(20 + 60 * t)},${Math.round(60 + 120 * (1 - t))})`;
    ctx.fillRect(p * cell, c * cell, cell, cell);
  }
  cv.addEventListener('mousemove', e => {
    const r = cv.getBoundingClientRect();
    const p = Math.floor((e.clientX - r.left) / cell);
    const c = Math.floor((e.clientY - r.top) / cell);
    if (p < 0 || p >= P || c < 0 || c >= C) {
      tip.style.display = 'none'; return;
    }
    showTip(e, `${n} \\u00b7 ${classes[c]} / P${p}: ` +
        W[c][p].toFixed(4));
  });
  cv.addEventListener('mouseleave', () => tip.style.display = 'none');
}
</script></body></html>
"""


def build_comparison_html(explanations, out_dir):
    """Self-contained interactive cross-run comparator (stands in for the
    reference's plotly figures, reference interp_many.py:165)."""
    import json

    runs = {}
    for name, expl in explanations.items():
        w = np.asarray(expl["weights"], np.float64)
        classes = expl.get("classes") or [f"class_{i}"
                                          for i in range(w.shape[0])]
        runs[name] = {
            "W": [[round(float(v), 6) for v in row] for row in w],
            "classes": list(classes)[:w.shape[0]],
        }
    path = os.path.join(out_dir, "runs_compare.html")
    with open(path, "w") as f:
        f.write(_COMPARE_TEMPLATE.replace("__RUNS__", json.dumps(runs)))
    print(f"Interactive run comparator: {path}")
    return path


def summary_table(explanations, out_dir):
    """CSV summary: run, #prototypes, #active (importance > 1e-3),
    sparsity."""
    lines = ["run,num_prototypes,num_active,importance_sparsity"]
    for name, expl in explanations.items():
        w = expl["weights"]
        active = int((w.max(axis=0) > 1e-3).sum())
        sparsity = float((w <= 1e-3).mean())
        lines.append(f"{name},{w.shape[1]},{active},{sparsity:.4f}")
    path = os.path.join(out_dir, "runs_summary.csv")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"Summary table: {path}")


def main():
    ap = argparse.ArgumentParser("Compare multiple trained runs")
    ap.add_argument("--run_dirs", nargs="+", required=True)
    ap.add_argument("--out_dir", default="./analysis")
    ap.add_argument("--checkpoint", default="net_best")
    args = ap.parse_args()
    run_analysis_pipeline(args.run_dirs, args.out_dir, args.checkpoint)


if __name__ == "__main__":
    main()
