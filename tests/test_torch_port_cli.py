"""The port's command line end to end on the CPU (``--disable_cuda``): the
verify recipe with ``--fused_blocks`` on a generated shapes dataset writes
the 15-column CSV and the checkpoint roles with their sidecars, and
``--resume_training`` continues the run; the same recipe on the
whole-block route with the device augmentation, and on the depthwise +
fused-MLP route; without a CUDA device and without ``--disable_cuda`` it
exits non-zero; its flags and defaults are the JAX package's; flags whose
path is not ported raise."""

import argparse
import csv
import json
import os
import pathlib
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
    gen = _run(["-m", "count_pipnet_tpu.data.generate_shapes",
                "--output_dir", "./data/geometric_shapes/dataset",
                "--img_size", "64", "--train_samples_per_class", "4",
                "--test_samples_per_class", "2", "--seed", "0"], cwd)
    assert gen.returncode == 0, gen.stderr[-2000:]


def _check_artifacts(run):
    """The 15-column CSV of one pretrain and two main epochs, and the
    checkpoint roles with their sidecars."""
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


def test_cli_trains_writes_artifacts_and_resumes(tmp_path):
    _generate_shapes(tmp_path)
    cli = ["-m", "count_pipnet_tpu_torch.main", *RECIPE, "--disable_cuda"]
    res = _run(cli + ["--epochs", "2"], tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    run = tmp_path / "runs" / "vfy"
    _check_artifacts(run)

    res = _run(cli + ["--epochs", "3", "--resume_training"], tmp_path)
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
    """The recipe on the routes of the flagship configs: the CSV and the
    checkpoint roles, and (with the device augmentation) the loader's
    single-view batches went through the device augmentation."""
    _generate_shapes(tmp_path)
    recipe = [a for a in RECIPE if a != "--fused_blocks"]
    res = _run(["-m", "count_pipnet_tpu_torch.main", *recipe, *flags,
                "--disable_cuda", "--epochs", "2"], tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "unsupported" not in res.stdout
    _check_artifacts(tmp_path / "runs" / "vfy")


def test_cli_needs_a_card_without_disable_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run(["-m", "count_pipnet_tpu_torch.main", *RECIPE], tmp_path)
    assert res.returncode != 0
    assert "--disable_cuda" in res.stderr


def test_parser_defaults_equal_the_jax_package():
    assert DEFAULTS == JAX_DEFAULTS


@pytest.mark.parametrize("flags,item", [
    ([], "Queue 1 item 7"),                     # --model pipnet (default)
    (["--mesh_shape", "4"], "Queue 1 item 5"),
    (["--interpret"], "Queue 1 item 8"),
    (["--intermediate_layer", "linear"], "Queue 1 item d"),
    (["--net", "resnet50"], "Queue 1 item f"),
])
def test_unported_flags_raise(flags, item):
    model = [] if not flags else ["--model", "count_pipnet"]
    args = build_parser().parse_args(model + flags)
    with pytest.raises(NotImplementedError, match=item):
        check_ported(args)
    check_ported(argparse.Namespace(**dict(vars(build_parser().parse_args(
        ["--model", "count_pipnet"])))))
