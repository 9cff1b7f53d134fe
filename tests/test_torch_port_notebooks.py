"""The port's copies of the notebooks that load trained runs
(count_pipnet_tpu_torch/notebooks/) and its copy of the prototype-group
registry (count_pipnet_tpu_torch/interpret/enums.py):

* the cases of tests/test_interpret.py's explorer, comparator, grouped
  static heatmap and group-definition tests on the copies, the explorer
  on a port run directory (``torch.save`` net_best and pickled args) of
  a tiny Count-PIPNet;
* the global explanation of a JAX run (tests/
  test_torch_port_interpret_idg.py) equal to the JAX package's notebook's
  within 1e-6 of its largest weight, and the one of the port run equal
  to ``importance_per_class``;
* ``viz_prototype_maps`` renders the JAX notebook's tree on a JAX
  PIP-Net run (``--disable_cuda``);
* notebooks/evaluate_runs.py (it imports neither package) groups and
  reports port run trees: the CSV written by the port's ``Log`` with the
  trainer's columns."""

import importlib.util
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from count_pipnet_tpu_torch.config import build_parser, save_args
from count_pipnet_tpu_torch.interpret.enums import (GROUP_COLORS,
                                                    build_group_definitions,
                                                    groups_for_run,
                                                    register_groups)
from count_pipnet_tpu_torch.models.pipnet import (get_count_network,
                                                  importance_per_class)
from count_pipnet_tpu_torch.notebooks.interp_explorer import build_explorer
from count_pipnet_tpu_torch.notebooks.interp_many import \
    build_comparison_html
from count_pipnet_tpu_torch.notebooks import viz_prototype_maps
from count_pipnet_tpu_torch.notebooks.main_interp import (
    calculate_global_explanation, show_global_explanation)
from count_pipnet_tpu_torch.train.trainer import LOG_COLUMNS
from count_pipnet_tpu_torch.utils.checkpoint import CheckpointManager
from count_pipnet_tpu_torch.utils.log import Log
from test_torch_port_interpret_idg import (  # noqa: F401
    make_dataset, make_jax_run, two_threads)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NC = 4


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port run directory of a tiny onehot Count-PIPNet, 8 prototypes,
    the classifier from a seed."""
    run = tmp_path_factory.mktemp("nb") / "onehot_seed1_20260101_000000"
    args = build_parser().parse_args([
        "--model", "count_pipnet", "--net", "convnext_tiny_26",
        "--use_mid_layers", "--num_stages", "1", "--num_features", "8",
        "--image_size", "32", "--dataset", "geometric_shapes",
        "--disable_cuda", "--log_dir", str(run)])
    torch.manual_seed(0)
    model, _ = get_count_network(NC, args, max_count=3)
    with torch.no_grad():
        w = torch.from_numpy(np.random.default_rng(1).normal(
            1.0, 0.5, model.classification.weight.shape).astype(np.float32))
        model.classification.weight.copy_(w.clamp(min=0))
    save_args(args, str(run / "metadata"))
    CheckpointManager(args).save_best_checkpoint(model.state_dict(), {}, 1,
                                                 0.5)
    return run, model


def test_global_explanation_of_a_port_run(port_run):
    run, model = port_run
    expl = calculate_global_explanation(str(run))
    assert expl["weights"].shape == (NC, 8)
    np.testing.assert_array_equal(expl["weights"],
                                  importance_per_class(model).numpy())


def test_global_explanation_matches_the_jax_notebook(tmp_path):
    sys.path.insert(0, str(ROOT))
    from notebooks.main_interp import calculate_global_explanation as j_calc
    run = str(make_jax_run(tmp_path, "count")[0])
    want = j_calc(run)["weights"]
    got = calculate_global_explanation(run)["weights"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_explorer_html_self_contained(port_run):
    run, _ = port_run
    out = build_explorer(str(run))
    html = open(out).read()
    assert "<script src" not in html  # no CDN/external scripts
    w = json.loads(re.search(r"const W = (\[\[.*?\]\]);",
                             html, re.S).group(1))
    classes = json.loads(re.search(r"const classNames = (\[.*?\]);",
                                   html, re.S).group(1))
    assert len(w) == len(classes) == NC
    assert len(w[0]) == 8
    for frag in ("addEventListener('mousemove'",
                 "addEventListener('click'", "<select id=\"cls\">"):
        assert frag in html, frag


def test_explorer_grouped_view(port_run, tmp_path):
    """Columns ordered by group priority under a coloured band, the
    per-prototype labels embedded, the top-k filter present."""
    run, _ = port_run
    spec = {"groups": {"count": [0, 3], "shape": [4], "mixed": [2]},
            "labels": {"0": "Count-1", "4": "Circ(:)"}}
    gpath = tmp_path / "groups.json"
    gpath.write_text(json.dumps(spec))
    out = build_explorer(str(run), out_path=str(tmp_path / "e.html"),
                         groups_json=str(gpath))
    html = open(out).read()
    defs = json.loads(re.search(r"const DEFS = (\[.*?\]);",
                                html, re.S).group(1))
    assert defs[0]["label"] == "Count-1"
    assert defs[0]["group_name"] == "count"
    assert defs[4]["group_name"] == "shape"
    assert defs[4]["order_priority"] < defs[0]["order_priority"]
    assert defs[1]["group_name"] == "dead"
    for frag in ('id="legend"', 'id="topk"', "order.sort"):
        assert frag in html, frag


def test_comparison_html(tmp_path):
    expl = {
        "runA": {"weights": np.asarray([[0.0, 2.0], [1.0, 0.0]])},
        "runB": {"weights": np.asarray([[1.5, 0.0], [0.0, 0.5]])},
    }
    out = build_comparison_html(expl, str(tmp_path))
    html = open(out).read()
    assert "<script src" not in html
    runs = json.loads(re.search(r"const RUNS = (\{.*?\});\n",
                                html, re.S).group(1))
    assert set(runs) == {"runA", "runB"}
    assert runs["runA"]["W"] == [[0.0, 2.0], [1.0, 0.0]]
    assert len(runs["runA"]["classes"]) == 2
    script = html.split("<script>")[1].split("</script>")[0]
    for o, c in [("{", "}"), ("(", ")"), ("[", "]")]:
        assert script.count(o) == script.count(c)
    for frag in ("drawScatter", "id=\"toggles\"",
                 "addEventListener('mousemove'"):
        assert frag in html, frag


def test_grouped_static_heatmap(tmp_path):
    w = np.zeros((3, 4))
    w[0, 3] = 2.0
    w[1, 0] = 1.0
    defs = build_group_definitions(4, {"shape": [3], "count": [0]},
                                   labels={3: "Circ(:)"})
    out = tmp_path / "g.png"
    lines = show_global_explanation({"weights": w}, str(out),
                                    group_defs=defs)
    assert out.exists() and out.stat().st_size > 0
    # the listing keeps the prototypes' own indices despite the reorder
    assert "P3(2.000)" in lines[0]
    assert "P0(1.000)" in lines[1]


def test_group_overlap_raises():
    with pytest.raises(ValueError, match="multiple groups"):
        build_group_definitions(4, {"a": [0, 1], "b": [1]})


def test_group_out_of_range_raises():
    with pytest.raises(ValueError, match="outside"):
        build_group_definitions(4, {"a": [7]})


def test_dead_and_custom_groups():
    defs = build_group_definitions(5, {"count": [0], "texture": [2, 3]},
                                   labels={0: "Count-1"})
    assert [d["group_name"] for d in defs] == \
        ["count", "dead", "texture", "texture", "dead"]
    assert defs[0]["label"] == "Count-1"
    assert defs[1]["label"] == "Dead"
    assert defs[2]["color"].startswith("#")
    assert defs[2]["order_priority"] > defs[0]["order_priority"]
    assert defs[0]["color"] == GROUP_COLORS["count"]


def test_group_registry_roundtrip():
    register_groups("runX", {"count": [1, 2]})
    assert groups_for_run("runX") == {"count": [1, 2]}
    assert groups_for_run("missing") == {}


def test_evaluate_runs_reads_port_runs(tmp_path):
    """Two seeds of one config and another config, each a port run tree
    (the trainer's CSV columns through the port's Log)."""
    spec = importlib.util.spec_from_file_location(
        "evaluate_runs", ROOT / "notebooks" / "evaluate_runs.py")
    ev = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ev)
    for name, accs in (("cfgA_seed1_20260101_000000", [0.2, 0.5, 0.4]),
                       ("cfgA_seed2_20260101_000001", [0.1, 0.3, 0.7]),
                       ("cfgB_20260101_000002", [0.9])):
        log = Log(str(tmp_path / name))
        log.create_log("log_epoch_overview", "epoch", *LOG_COLUMNS)
        log.log_values("log_epoch_overview", 1, *(["n.a."] * 7),
                       1.0, 0.5, 0.5, "n.a.", 2.5, 1.0, "n.a.")
        for i, a in enumerate(accs):
            log.log_values("log_epoch_overview", i + 1, a, 2.0, 3.0, 4.0,
                           5.0, 6, 0.5, 0.5, 0.1, 0.2, 0.3, 0.5, 0.4, 0.6)
    groups = ev.collect([str(p) for p in tmp_path.iterdir()])
    assert set(groups) == {"cfgA", "cfgB"}
    assert len(groups["cfgA"]) == 2
    table = ev.report(groups, str(tmp_path / "out"))
    assert "cfgA" in table and "0.600" in table  # mean(0.5, 0.7)


def test_viz_prototype_maps_renders_the_jax_tree(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT))
    from notebooks import viz_prototype_maps as j_viz
    make_dataset(tmp_path)
    run = make_jax_run(tmp_path, "pipnet")[0]
    monkeypatch.chdir(tmp_path)
    flags = ["--run_dir", str(run), "--k", "3", "--max_maps", "1"]
    assert viz_prototype_maps.main(flags + ["--out_folder", "port",
                                            "--disable_cuda"]) == 0
    monkeypatch.setattr(sys, "argv", ["viz"] + flags + ["--out_folder",
                                                        "jax"])
    j_viz.main()

    def tree(name):
        return sorted(p.relative_to(run / name).as_posix()
                      for p in (run / name).rglob("*"))

    assert tree("port") == tree("jax")
    assert "grid_topk_all.png" in tree("port")
    assert any(n.endswith("_overlay.png") for n in tree("port"))
