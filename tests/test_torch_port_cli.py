"""The port's command line end to end on the CPU (``--disable_cuda``): the
verify recipe with ``--fused_blocks`` on a shapes dataset made by the
port's generator writes the 15-column CSV, the checkpoint roles with
their sidecars and the prototype visualisations (after pretraining and of
the best model, its prototype maps too), and ``--resume_training``
continues the run; the same recipe on the whole-block route with the
device augmentation, on the depthwise + fused-MLP route, with the
default ``--model pipnet``, with the bilinear intermediate and on a
resnet18 PIP-Net; with ``--interpret`` it writes the interpretability
suite's artifacts; without a CUDA device and without ``--disable_cuda``
it exits non-zero; its flags and defaults are the JAX package's; no flag
is left unported (``--mesh_shape`` was the last), and a Count-PIPNet on a
ResNet raises as in the JAX package."""

import argparse
import csv
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from count_pipnet_tpu.config import DEFAULTS as JAX_DEFAULTS
from count_pipnet_tpu_torch.config import DEFAULTS, build_parser
from count_pipnet_tpu_torch.train.trainer import check_ported

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECIPE = [
    "--dataset", "geometric_shapes", "--model", "count_pipnet",
    "--image_size", "64", "--net", "convnext_tiny_26", "--use_mid_layers",
    "--num_stages", "1", "--num_features", "8", "--max_count", "3",
    "--use_ste", "True", "--intermediate_layer", "onehot",
    "--batch_size", "8", "--batch_size_pretrain", "8", "--epochs_pretrain",
    "1", "--epochs_finetune", "1", "--freeze_epochs", "0", "--lr", "0.01",
    "--lr_block", "0.001", "--lr_net", "0.001", "--num_workers", "2",
    "--seed", "1", "--dtype", "float32", "--tanh_loss_coeff", "0.1",
    "--disable_pretrained", "--log_dir", "./runs/vfy", "--fused_blocks"]
ROLES = ("net_pretrained", "net_trained", "net_trained_last", "net_best")


def _run(args, cwd, **kw):
    # a tiny model: two threads a process keep the parallel test run fast
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def _generate_shapes(cwd):
    gen = _run(["-m", "count_pipnet_tpu_torch.data.generate_shapes",
                "--output_dir", "./data/geometric_shapes/dataset",
                "--img_size", "64", "--train_samples_per_class", "4",
                "--test_samples_per_class", "2", "--seed", "0"], cwd)
    assert gen.returncode == 0, gen.stderr[-2000:]


def _check_artifacts(run, maps=True):
    """The 15-column CSV of one pretrain and two main epochs, the
    checkpoint roles with their sidecars, and the top-k grids after
    pretraining and of the best model (with ``maps``, its prototype
    maps)."""
    with open(run / "log_epoch_overview.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows[0]) == 15 and rows[0][0] == "epoch"
    assert [r[0] for r in rows[1:]] == ["1", "1", "2"]
    assert rows[1][1] == "n.a." and float(rows[2][1]) >= 0.0
    ck = run / "checkpoints"
    for role in ROLES:
        assert (ck / role).is_file() and (ck / f"{role}.json").is_file()
    assert len(list(ck.glob("net_pretrained_*.json"))) == 1
    assert json.loads((ck / "net_trained_last.json").read_text())[
        "epoch"] == 2
    assert (run / "out.txt").is_file()
    assert (run / "metadata" / "args.txt").is_file()
    pre = run / "visualised_pretrained_prototypes_topk"
    assert len(list(pre.glob("grid_topk_*.png"))) >= 2
    assert list(pre.glob("prototype_*/p*_0_sim*.png"))
    best, = run.glob("visualised_prototypes_topk_best_model_epoch*")
    assert (best / "grid_topk_all.png").is_file()
    assert list(best.glob("grid_topk_[0-9]*.png"))
    assert bool(list(best.glob("feature_maps/prototype_*/*_overlay.png"))) \
        == maps


def test_cli_trains_writes_artifacts_and_resumes(tmp_path):
    _generate_shapes(tmp_path)
    cli = ["-m", "count_pipnet_tpu_torch.main", *RECIPE, "--disable_cuda"]
    res = _run(cli + ["--epochs", "2"], tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    run = tmp_path / "runs" / "vfy"
    _check_artifacts(run)

    res = _run(cli + ["--epochs", "3", "--resume_training",
                      "--viz_prototype_maps", "False"], tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "Resuming from checkpoint" in res.stdout
    assert "Pretrain Epoch" not in res.stdout
    with open(run / "log_epoch_overview.csv") as f:
        assert [r[0] for r in csv.reader(f)][1:] == ["1", "1", "2", "3"]


@pytest.mark.parametrize("flags", [
    ["--fused_whole_blocks", "--device_augment", "--device_geometric"],
    ["--fused_dwconv", "--fused_blocks"],
], ids=["whole_blocks_device_augment", "dwconv_fused_blocks"])
def test_cli_new_routes_write_artifacts(tmp_path, flags):
    """The recipe on the routes of the flagship configs: the CSV, the
    checkpoint roles and the top-k grids (the prototype maps off, to keep
    the run short), and (with the device augmentation) the loader's
    single-view batches went through the device augmentation."""
    _generate_shapes(tmp_path)
    recipe = [a for a in RECIPE if a != "--fused_blocks"]
    res = _run(["-m", "count_pipnet_tpu_torch.main", *recipe, *flags,
                "--disable_cuda", "--epochs", "2",
                "--viz_prototype_maps", "False"], tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "unsupported" not in res.stdout
    assert "skipped" not in res.stdout
    _check_artifacts(tmp_path / "runs" / "vfy", maps=False)


def test_cli_pipnet_default_model_writes_artifacts(tmp_path):
    """The recipe with the CLI's default ``--model pipnet`` (no count
    flags; the softmax add-on whatever ``--activation`` says): the same
    CSV, checkpoint roles and visualisations, prototype maps included."""
    _generate_shapes(tmp_path)
    count_only = {"--model": 1, "--max_count": 1, "--use_ste": 1,
                  "--intermediate_layer": 1, "--tanh_loss_coeff": 1}
    recipe, skip = [], 0
    for a in RECIPE:
        if skip:
            skip -= 1
        elif a in count_only:
            skip = count_only[a]
        else:
            recipe.append(a)
    res = _run(["-m", "count_pipnet_tpu_torch.main", *recipe,
                "--disable_cuda", "--epochs", "2"], tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "skipped" not in res.stdout
    assert "Updated Gumbel-Softmax temperature" not in res.stdout
    run = tmp_path / "runs" / "vfy"
    assert "model: 'pipnet'" in (run / "metadata" / "args.txt").read_text()
    _check_artifacts(run)


def test_cli_interpret_writes_the_suite(tmp_path):
    """The recipe with ``--interpret``: after the scoring sheet, the
    prediction explanations of the test images under
    visualization_results/, the activation histograms, one IDG overlay a
    class under idg_attributions/; nothing skipped. At 32x32 with 2
    prototypes, one main epoch and without ``--fused_blocks`` (whose plain
    backward on the CPU would double the time; tests/
    test_torch_port_saliency.py holds that route's input gradient against
    JAX), so that the run and its attributions (128 steps in batches of
    32 for every active prototype of 9 images) stay short."""
    _generate_shapes(tmp_path)
    recipe = [a for a in _without(RECIPE, {"--image_size", "--num_features"})
              if a != "--fused_blocks"]
    res = _run(["-m", "count_pipnet_tpu_torch.main", *recipe,
                "--image_size", "32", "--num_features", "2",
                "--disable_cuda", "--epochs", "1", "--interpret",
                "--viz_prototype_maps", "False"], tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "skipped" not in res.stdout
    run = tmp_path / "runs" / "vfy"
    out = (run / "out.txt").read_text()
    classes = sorted(p.name for p in (
        tmp_path / "data/geometric_shapes/dataset/test").iterdir())
    for c, name in enumerate(classes):
        assert f"Class {c} ({name}): has " in out
    assert out.index("relevant prototypes") < out.index(
        "Prediction explanations saved") < out.index(
        "Attribution overlays saved")
    overlays = sorted(p.name for p in (run / "idg_attributions").iterdir())
    assert len(overlays) == len(classes)
    for o, c in zip(overlays, classes):
        assert o.startswith(c + "_") and o.endswith("_IDG.png"), o
    active = [int(n) for n in re.findall(r"attributed .*: (\d+) active",
                                         out)]
    assert len(active) == len(classes) and sum(active) > 0, active
    explained = run / "visualization_results"
    assert sorted(p.name for p in explained.iterdir()) == sorted(
        p.stem for p in (tmp_path / "data/geometric_shapes/dataset/test")
        .rglob("*.png"))
    assert list(explained.glob("*/0_*_output*/mul*_p*_sim*_w*_rect.png"))
    assert (run / "activation_histograms" / "summary_heatmap.png").is_file()


def _without(recipe, flags):
    """``recipe`` without ``flags`` (each with its one value)."""
    out, skip = [], False
    for a in recipe:
        if skip:
            skip = False
        elif a in flags:
            skip = True
        else:
            out.append(a)
    return out


@pytest.mark.parametrize("flags", [
    ["--intermediate_layer", "bilinear"],
    ["--net", "resnet18"],
], ids=["count_pipnet_bilinear", "pipnet_resnet18"])
def test_cli_intermediates_and_resnets_write_artifacts(tmp_path, flags):
    """A bilinear Count-PIPNet and a resnet18 PIP-Net (the default
    ``--model pipnet`` without the count flags) at 64x64 write the CSV,
    the checkpoint roles and the top-k grids (the prototype maps off)."""
    _generate_shapes(tmp_path)
    recipe = [a for a in RECIPE if a != "--fused_blocks"]
    if flags[0] == "--net":
        recipe = _without(recipe, {"--model", "--max_count", "--use_ste",
                                   "--intermediate_layer", "--net",
                                   "--tanh_loss_coeff"})
    else:
        recipe = _without(recipe, {"--intermediate_layer"})
    res = _run(["-m", "count_pipnet_tpu_torch.main", *recipe, *flags,
                "--disable_cuda", "--epochs", "2",
                "--viz_prototype_maps", "False"], tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "skipped" not in res.stdout
    run = tmp_path / "runs" / "vfy"
    args_txt = (run / "metadata" / "args.txt").read_text()
    assert f"{flags[0][2:]}: '{flags[1]}'" in args_txt
    _check_artifacts(run, maps=False)


def test_cli_needs_a_card_without_disable_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run(["-m", "count_pipnet_tpu_torch.main", *RECIPE], tmp_path)
    assert res.returncode != 0
    assert "--disable_cuda" in res.stderr


def test_parser_defaults_equal_the_jax_package():
    assert DEFAULTS == JAX_DEFAULTS


@pytest.mark.parametrize("flags,item", [
    (["--mesh_shape", "4"], "Queue 1: Multi-GPU training"),
])
def test_unported_flags_raise(flags, item):
    """The flags that raised while their ROADMAP item was open pass now
    that it is ported (``--mesh_shape N`` trains on N ranks,
    tests/test_torch_port_parallel.py), and no flag is left to raise."""
    from count_pipnet_tpu_torch.train.trainer import UNPORTED
    args = build_parser().parse_args(["--model", "count_pipnet"] + flags)
    check_ported(args)
    assert not any(item in what for _, what in UNPORTED)
    assert UNPORTED == ()
    check_ported(argparse.Namespace(**dict(vars(build_parser().parse_args(
        ["--model", "count_pipnet"])))))


@pytest.mark.parametrize("flags", [
    ["--model", "count_pipnet", "--intermediate_layer", "linear"],
    ["--net", "resnet50"],
    ["--model", "count_pipnet", "--interpret"],
], ids=["count_pipnet_linear", "pipnet_resnet50", "interpret"])
def test_ported_flags_pass(flags):
    """The other intermediates, the ResNet backbones and the
    interpretability suite are ported."""
    check_ported(build_parser().parse_args(flags))


def test_count_pipnet_on_a_resnet_raises():
    """As in the JAX package, a Count-PIPNet is ConvNeXt only."""
    from count_pipnet_tpu_torch.train.trainer import Trainer
    args = build_parser().parse_args(["--model", "count_pipnet", "--net",
                                      "resnet18", "--disable_cuda"])
    with pytest.raises(ValueError, match=r"Supported networks: "
                       r"\['convnext_tiny_26', 'convnext_tiny_13'\]"):
        Trainer(args, 3)


@pytest.mark.parametrize("flags", [[], ["--intermediate_layer", "linear"]],
                         ids=["default", "intermediate_unused"])
def test_pipnet_is_ported(flags):
    """The CLI's defaults (``--model pipnet``) pass the check; PIP-Net has
    no intermediate layer, so ``--intermediate_layer`` does not stop it."""
    check_ported(build_parser().parse_args(flags))
