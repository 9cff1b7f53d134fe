"""The port's sweep runner (count_pipnet_tpu_torch/run_multiple_configs.py)
on the cases of tests/test_sweep_runner.py: config sequencing, the shared
pretrained-backbone cache, summary.json, stop or continue on error, the
compatibility check; and its subprocess mode, which runs ``python -m
count_pipnet_tpu_torch.main --config <yaml>`` with the flags that differ
from the port's defaults."""

import argparse
import copy
import json
import os
import subprocess

import yaml

from count_pipnet_tpu_torch import run_multiple_configs as rmc
from count_pipnet_tpu_torch.config import DEFAULTS
from count_pipnet_tpu_torch.train import trainer as trainer_mod


def write_config(path, **over):
    cfg = dict(
        model="count_pipnet", dataset="geometric_shapes", image_size=64,
        net="convnext_tiny_26", use_mid_layers=True, num_stages=1,
        num_features=8, seed=1, epochs=1, epochs_pretrain=1,
        activation="gumbel_softmax",
    )
    cfg.update(over)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


class Cmd:
    def __init__(self, config_list, log_root, continue_on_error=False,
                 in_process=True):
        # in-process, so that run_pipnet can be monkeypatched
        self.config_list = config_list
        self.log_root = log_root
        self.continue_on_error = continue_on_error
        self.in_process = in_process


def test_sweep_shares_backbone_and_writes_summary(tmp_path, monkeypatch):
    cfg_a = tmp_path / "a.yaml"
    cfg_b = tmp_path / "b.yaml"      # same pretrain key as a
    cfg_c = tmp_path / "c.yaml"      # different num_features
    write_config(cfg_a)
    write_config(cfg_b, intermediate_layer="linear")
    write_config(cfg_c, num_features=4)
    clist = tmp_path / "list.json"
    clist.write_text(json.dumps([str(cfg_a), str(cfg_b), str(cfg_c)]))

    calls = []

    def fake_run(args):
        calls.append(args)
        # a real run writes net_pretrained; the runner only caches dirs
        # that actually hold one
        ckpt_dir = os.path.join(args.log_dir, "checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, "net_pretrained"), "wb") as f:
            f.write(b"x")

    monkeypatch.setattr(trainer_mod, "run_pipnet", fake_run)

    summary = rmc.run_all_configs(Cmd(str(clist), str(tmp_path / "runs")))
    assert [r["status"] for r in summary["runs"]] == ["success"] * 3
    # run b shares run a's pretrained dir; run c (different key) does not
    assert calls[1].pretrained_checkpoints_dir == calls[0].log_dir
    assert calls[2].pretrained_checkpoints_dir != calls[0].log_dir
    assert calls[1].intermediate_layer == "linear"
    assert (tmp_path / "runs/summary.json").exists()


def test_sweep_stops_or_continues_on_error(tmp_path, monkeypatch):
    cfg_a = tmp_path / "a.yaml"
    cfg_b = tmp_path / "b.yaml"
    write_config(cfg_a)
    write_config(cfg_b)
    clist = tmp_path / "list.json"
    clist.write_text(json.dumps([str(cfg_a), str(cfg_b)]))

    def fail_run(args):
        raise RuntimeError("boom")

    monkeypatch.setattr(trainer_mod, "run_pipnet", fail_run)

    summary = rmc.run_all_configs(Cmd(str(clist), str(tmp_path / "r1")))
    assert len(summary["runs"]) == 1  # stopped at first failure

    summary = rmc.run_all_configs(
        Cmd(str(clist), str(tmp_path / "r2"), continue_on_error=True))
    assert [r["status"] for r in summary["runs"]] == ["failed", "failed"]


def test_compatibility_check():
    a = argparse.Namespace(seed=1, num_stages=2, num_features=8,
                           net="convnext_tiny_26", dataset="d",
                           use_mid_layers=True,
                           activation="gumbel_softmax", image_size=64)
    b = copy.deepcopy(a)
    assert rmc.verify_compatible_pretraining_params(a, b)
    b.activation = "softmax"
    assert not rmc.verify_compatible_pretraining_params(a, b)


def test_subprocess_mode_runs_the_port_cli(tmp_path, monkeypatch):
    """Each run is ``python -m count_pipnet_tpu_torch.main --config <tmp
    yaml>``, the YAML holding the flags that differ from the defaults and
    the run's log dir; a non-zero exit fails the run."""
    cfg = tmp_path / "a.yaml"
    write_config(cfg, fused_blocks=True)
    clist = tmp_path / "list.json"
    clist.write_text(json.dumps([str(cfg), str(cfg)]))
    seen = []

    def fake_subprocess_run(cmd):
        with open(cmd[-1]) as f:
            seen.append((cmd, yaml.safe_load(f)))
        return subprocess.CompletedProcess(cmd, len(seen) - 1)

    monkeypatch.setattr(subprocess, "run", fake_subprocess_run)
    summary = rmc.run_all_configs(Cmd(str(clist), str(tmp_path / "runs"),
                                      continue_on_error=True,
                                      in_process=False))
    assert [r["status"] for r in summary["runs"]] == ["success", "failed"]
    assert "exit code 1" in summary["runs"][1]["error"]
    cmd, written = seen[0]
    assert cmd[1:4] == ["-m", "count_pipnet_tpu_torch.main", "--config"]
    assert not os.path.exists(cmd[-1])  # the temporary YAML is removed
    assert written["log_dir"] == summary["runs"][0]["log_dir"]
    assert written["fused_blocks"] is True and written["num_stages"] == 1
    assert all(v != DEFAULTS[k] for k, v in written.items()
               if k != "log_dir")
