"""Interactive class <-> prototype explorer (self-contained HTML).

The port's copy of notebooks/interp_explorer.py.

The reference ships plotly-based interactive global-explanation
explorers (reference notebooks/main_interp.py:345-880). Without
plotly or a network (CDN scripts would not load), the explorer is a
single self-contained HTML file: the virtual weight matrix is embedded
as JSON and rendered with vanilla JS —
a hoverable class x prototype heatmap, a class selector with a sorted
relevant-prototype bar list, and links into the run's prototype patch
grids when present.

The grouped view (reference main_interp.py:533-880) activates when
prototype groups are available — via ``--groups_json`` (a file with
``{"groups": {name: [indices]}, "labels": {"idx": str},
"colors": {name: css}, "priority": {name: int}}``) or a set registered
under the run name in
``count_pipnet_tpu_torch.interpret.enums``. Columns are
then ordered by group priority under a colored group band with a
legend, tooltips carry the per-prototype semantic labels, and a top-k
filter mirrors the reference's ``top_k_prototypes`` masking.

Usage:
    python -m count_pipnet_tpu_torch.notebooks.interp_explorer \
        --run_dir ./runs/<run> \
        [--out explorer.html] [--groups_json groups.json]
"""

import argparse
import glob
import json
import os

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Count-PIPNet explorer</title>
<style>
 body { font-family: sans-serif; margin: 16px; background: #fafafa; }
 #wrap { display: flex; gap: 24px; flex-wrap: wrap; }
 canvas { border: 1px solid #888; image-rendering: pixelated; }
 #tip { position: fixed; background: #222; color: #fff; padding: 4px 8px;
        border-radius: 4px; font-size: 12px; pointer-events: none;
        display: none; z-index: 10; }
 .bar { height: 18px; background: #7a3ff0; margin: 2px 0;
        color: #fff; font-size: 12px; padding: 1px 4px;
        white-space: nowrap; }
 #bars { min-width: 320px; max-width: 540px; }
 select { font-size: 14px; margin-bottom: 8px; }
 a { color: #4444cc; }
 h3 { margin: 8px 0 4px 0; }
</style></head><body>
<h2>Global explanation — class &harr; prototype virtual weights</h2>
<p>__META__</p>
<div id="tip"></div>
<div id="wrap">
 <div>
  <h3>Heatmap (hover for values, click a row to select the class)</h3>
  <div id="legend" style="margin:4px 0; font-size:13px;"></div>
  <label style="font-size:13px;">top-k prototypes per class:
   <select id="topk"><option value="0">all</option>
    <option value="1">1</option><option value="2">2</option>
    <option value="3">3</option><option value="5">5</option>
    <option value="10">10</option></select></label>
  <br><canvas id="hm"></canvas>
 </div>
 <div id="bars">
  <h3>Relevant prototypes for
      <select id="cls"></select></h3>
  <div id="barlist"></div>
 </div>
</div>
<script>
const W = __WEIGHTS__;
const classNames = __CLASSES__;
const protoLinks = __PROTO_LINKS__;
const DEFS = __DEFS__;  // null, or per-prototype group definitions
const C = W.length, P = W[0].length;
// column order: group priority then index when groups are defined
let order = [...Array(P).keys()];
if (DEFS) order.sort((a, b) =>
    (DEFS[a].order_priority - DEFS[b].order_priority) || (a - b));
const label = p => DEFS ? DEFS[p].label : `P${p}`;
const cell = Math.max(4, Math.min(18, Math.floor(900 / P)));
const bandH = DEFS ? 10 : 0;
const cv = document.getElementById('hm');
cv.width = P * cell; cv.height = C * cell + bandH;
const ctx = cv.getContext('2d');
let wmax = 0;
for (const row of W) for (const v of row) wmax = Math.max(wmax, v);
let topk = 0;  // 0 = no masking
function kept(c) {  // set of column positions kept under the top-k mask
  if (!topk) return null;
  const idx = [...Array(P).keys()].sort((a, b) => W[c][b] - W[c][a]);
  return new Set(idx.slice(0, topk));
}
function color(v) {
  const t = wmax > 0 ? v / wmax : 0;
  const r = Math.round(20 + 235 * t);
  const g = Math.round(20 + 60 * t);
  const b = Math.round(60 + 120 * (1 - t));
  return `rgb(${r},${g},${b})`;
}
function draw(sel) {
  if (DEFS) for (let j = 0; j < P; j++) {
    ctx.fillStyle = DEFS[order[j]].color;
    ctx.fillRect(j * cell, 0, cell, bandH - 2);
  }
  for (let c = 0; c < C; c++) {
    const keep = kept(c);
    for (let j = 0; j < P; j++) {
      const p = order[j];
      ctx.fillStyle = (keep && !keep.has(p)) ? '#e8e8e8' : color(W[c][p]);
      ctx.fillRect(j * cell, bandH + c * cell, cell, cell);
    }
  }
  if (sel >= 0) {
    ctx.strokeStyle = '#00e0ff'; ctx.lineWidth = 2;
    ctx.strokeRect(0, bandH + sel * cell, P * cell, cell);
  }
}
if (DEFS) {
  const seen = new Map();
  for (const d of DEFS) if (!seen.has(d.group_name))
      seen.set(d.group_name, d.color);
  const lg = document.getElementById('legend');
  for (const [name, col] of seen) {
    const s = document.createElement('span');
    s.style.marginRight = '12px';
    s.innerHTML = `<span style="display:inline-block;width:12px;` +
        `height:12px;background:${col};margin-right:4px;"></span>${name}`;
    lg.appendChild(s);
  }
}
const tip = document.getElementById('tip');
cv.addEventListener('mousemove', e => {
  const r = cv.getBoundingClientRect();
  const j = Math.floor((e.clientX - r.left) / cell);
  const c = Math.floor((e.clientY - r.top - bandH) / cell);
  if (j < 0 || j >= P || c < 0 || c >= C) { tip.style.display = 'none';
                                            return; }
  const p = order[j];
  tip.style.display = 'block';
  tip.style.left = (e.clientX + 12) + 'px';
  tip.style.top = (e.clientY + 12) + 'px';
  tip.textContent = `${classNames[c]} / P${p}` +
      (DEFS ? ` [${label(p)}, ${DEFS[p].group_name}]` : '') + ': ' +
      W[c][p].toFixed(4);
});
cv.addEventListener('mouseleave', () => tip.style.display = 'none');
cv.addEventListener('click', e => {
  const r = cv.getBoundingClientRect();
  const c = Math.floor((e.clientY - r.top - bandH) / cell);
  if (c >= 0 && c < C) { selEl.value = c; render(c); }
});
document.getElementById('topk').addEventListener('change', e => {
  topk = +e.target.value; render(+selEl.value);
});
const selEl = document.getElementById('cls');
classNames.forEach((n, i) => {
  const o = document.createElement('option');
  o.value = i; o.textContent = n; selEl.appendChild(o);
});
function render(c) {
  draw(c);
  const list = document.getElementById('barlist');
  list.innerHTML = '';
  const entries = W[c].map((v, p) => [p, v])
      .filter(e => e[1] > 1e-3).sort((a, b) => b[1] - a[1]);
  const m = entries.length ? entries[0][1] : 1;
  for (const [p, v] of entries) {
    const d = document.createElement('div');
    d.className = 'bar';
    if (DEFS) d.style.background = DEFS[p].color;
    d.style.width = Math.max(8, 400 * v / m) + 'px';
    const link = protoLinks[p]
        ? ` <a style="color:#cfc" href="${protoLinks[p]}">grid</a>` : '';
    const tag = DEFS ? ` ${label(p)}` : '';
    d.innerHTML = `P${p}${tag} &nbsp; ${v.toFixed(3)}${link}`;
    list.appendChild(d);
  }
  if (!entries.length) list.textContent = '(no relevant prototypes)';
}
selEl.addEventListener('change', () => render(+selEl.value));
draw(-1); render(0);
</script></body></html>
"""


def _load_group_defs(run_dir, num_prototypes, groups_json=None):
    """Group definitions from --groups_json or the enums registry
    (reference main_interp.py:533-648 semantics), or None."""
    from ..interpret.enums import (build_group_definitions,
                                   groups_for_run, labels_for_run)

    run_name = os.path.basename(os.path.abspath(run_dir))
    if groups_json:
        with open(groups_json) as f:
            spec = json.load(f)
        return build_group_definitions(
            num_prototypes, spec.get("groups", {}),
            labels={int(k): v for k, v in spec.get("labels", {}).items()},
            colors=spec.get("colors"),
            priority=spec.get("priority"))
    groups = groups_for_run(run_name)
    if groups:
        return build_group_definitions(
            num_prototypes, groups, labels=labels_for_run(run_name))
    return None


def build_explorer(run_dir, out_path=None, checkpoint="net_best",
                   groups_json=None):
    from .main_interp import calculate_global_explanation

    expl = calculate_global_explanation(run_dir, checkpoint)
    w = np.asarray(expl["weights"], np.float64)
    C, P = w.shape
    defs = _load_group_defs(run_dir, P, groups_json)

    # class names from the dataset if discoverable, else class indices
    classes = [f"class_{i}" for i in range(C)]
    try:
        from ..data.registry import get_data
        res = get_data(expl["args"])
        if len(res[7]) == C:
            classes = list(res[7])
    except Exception:
        pass

    # per-prototype grid links (any visualised_* tree in the run dir)
    links = {}
    for p in range(P):
        hits = glob.glob(os.path.join(
            run_dir, "visualised_*", f"grid_topk_{p}.png"))
        if hits:
            links[p] = os.path.relpath(hits[0], run_dir)

    meta = (f"run: {os.path.basename(os.path.abspath(run_dir))} &mdash; "
            f"{C} classes &times; {P} prototypes, checkpoint "
            f"{checkpoint}")
    html = (_TEMPLATE
            .replace("__WEIGHTS__", json.dumps(
                [[round(float(v), 6) for v in row] for row in w]))
            .replace("__CLASSES__", json.dumps(classes))
            .replace("__PROTO_LINKS__", json.dumps(
                {str(k): v for k, v in links.items()}) if links else "{}")
            .replace("__DEFS__", json.dumps(defs) if defs else "null")
            .replace("__META__", meta))
    out_path = out_path or os.path.join(run_dir, "explorer.html")
    with open(out_path, "w") as f:
        f.write(html)
    print(f"Interactive explorer written to {out_path}")
    return out_path


def main():
    ap = argparse.ArgumentParser("Interactive class<->prototype explorer")
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--checkpoint", default="net_best")
    ap.add_argument("--out", default="")
    ap.add_argument("--groups_json", default="",
                    help="JSON with prototype groups/labels/colors for "
                         "the grouped view")
    args = ap.parse_args()
    build_explorer(args.run_dir, args.out or None, args.checkpoint,
                   groups_json=args.groups_json or None)


if __name__ == "__main__":
    main()
