"""Multi-config sweep runner of the port.

Port of the repository's root ``run_multiple_configs.py`` (reference
run_multiple_configs.py): runs a JSON list of YAML configs one after
another, sharing pretrained backbones across runs keyed by ``(seed,
num_stages, num_features)`` (:236,263-276), with per-run timestamped log
dirs (:160-163), ``--continue_on_error`` (:303-311), and a final
``summary.json`` with per-run status and wall-clock (:342-346).

By default each run executes in a subprocess (``python -m
count_pipnet_tpu_torch.main --config <temp.yaml>``), so that a crash or
the memory of one run does not reach the next; ``--in_process`` calls
``run_pipnet`` here instead. Pretrained-backbone sharing works across
subprocesses through ``pretrained_checkpoints_dir`` and the config-hash
discovery.

Usage:
    python -m count_pipnet_tpu_torch.run_multiple_configs \\
        --config_list config_list.json [--continue_on_error] \\
        [--log_root ./runs] [--in_process]
"""

import argparse
import json
import os
import time
import traceback
from datetime import datetime

from .config import DEFAULTS, args_from_yaml


def verify_compatible_pretraining_params(args_a, args_b) -> bool:
    """Two runs can share a pretrained backbone iff the pretraining-relevant
    architecture matches (reference run_multiple_configs.py:87-119)."""
    keys = ("seed", "num_stages", "num_features", "net", "dataset",
            "use_mid_layers", "activation", "image_size")
    return all(getattr(args_a, k, None) == getattr(args_b, k, None)
               for k in keys)


def create_namespace_from_config(config_path, log_root, timestamp=None):
    """YAML -> namespace with a per-run timestamped log dir
    (reference run_multiple_configs.py:121-179)."""
    timestamp = timestamp or datetime.now().strftime("%Y%m%d_%H%M%S")
    name = os.path.splitext(os.path.basename(config_path))[0]
    args = args_from_yaml(config_path)
    args.log_dir = os.path.join(log_root, f"{name}_{timestamp}")
    return args


def _run_in_subprocess(args):
    """Execute one run as ``python -m count_pipnet_tpu_torch.main --config
    <temp.yaml>``: the flags that differ from the CLI defaults."""
    import subprocess
    import sys
    import tempfile

    import yaml

    cfg = {k: v for k, v in vars(args).items()
           if k in DEFAULTS and v != DEFAULTS[k] and k != "config"}
    cfg["log_dir"] = args.log_dir
    with tempfile.NamedTemporaryFile(
            "w", suffix=".yaml", delete=False) as f:
        yaml.safe_dump(cfg, f)
        tmp = f.name
    try:
        res = subprocess.run([sys.executable, "-m",
                              "count_pipnet_tpu_torch.main", "--config",
                              tmp])
        if res.returncode != 0:
            raise RuntimeError(
                f"run failed with exit code {res.returncode} "
                f"(see {args.log_dir}/out.txt)")
    finally:
        os.unlink(tmp)


def run_all_configs(cmd_args):
    with open(cmd_args.config_list) as f:
        config_paths = json.load(f)
    if isinstance(config_paths, dict):
        config_paths = config_paths.get("configs", [])

    from .train import trainer as trainer_mod

    # pretrain-cache: (seed, num_stages, num_features) -> (ckpt_dir, args)
    pretrained_cache = {}
    summary = {"runs": [], "started": datetime.now().isoformat()}

    for config_path in config_paths:
        run_record = {"config": config_path, "status": "pending"}
        t0 = time.time()
        try:
            args = create_namespace_from_config(config_path,
                                                cmd_args.log_root)
            key = (args.seed, getattr(args, "num_stages", None),
                   args.num_features)
            cached = pretrained_cache.get(key)
            if cached is not None and verify_compatible_pretraining_params(
                    cached[1], args):
                print(f"Sharing pretrained backbone for key {key} from "
                      f"{cached[0]}", flush=True)
                args.pretrained_checkpoints_dir = cached[0]

            print(f"\n===== Running {config_path} -> {args.log_dir} =====",
                  flush=True)
            if getattr(cmd_args, "in_process", False):
                trainer_mod.run_pipnet(args)
            else:
                _run_in_subprocess(args)

            produced = os.path.exists(os.path.join(
                args.log_dir, "checkpoints", "net_pretrained"))
            if key not in pretrained_cache and produced:
                # only cache runs that actually WROTE a pretrained
                # checkpoint (a run that itself loaded a shared one has
                # nothing discoverable in its own dir)
                pretrained_cache[key] = (args.log_dir, args)
            elif key not in pretrained_cache and \
                    getattr(args, "pretrained_checkpoints_dir", ""):
                pretrained_cache[key] = (args.pretrained_checkpoints_dir,
                                         args)
            run_record["status"] = "success"
            run_record["log_dir"] = args.log_dir
        except Exception as e:
            run_record["status"] = "failed"
            run_record["error"] = str(e)
            traceback.print_exc()
            if not cmd_args.continue_on_error:
                run_record["wall_clock_s"] = time.time() - t0
                summary["runs"].append(run_record)
                break
        run_record["wall_clock_s"] = time.time() - t0
        summary["runs"].append(run_record)

    summary["finished"] = datetime.now().isoformat()
    os.makedirs(cmd_args.log_root, exist_ok=True)
    summary_path = os.path.join(cmd_args.log_root, "summary.json")
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"Sweep summary written to {summary_path}", flush=True)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser("Run multiple PIP-Net configs")
    p.add_argument("--config_list", default="config_list.json",
                   help="JSON file listing YAML config paths")
    p.add_argument("--log_root", default="./runs")
    p.add_argument("--continue_on_error", action="store_true")
    p.add_argument("--in_process", action="store_true",
                   help="run the configs in this process instead of one "
                        "subprocess each")
    cmd_args = p.parse_args(argv)
    run_all_configs(cmd_args)


if __name__ == "__main__":
    main()
