"""Run the port's CLI in resumable chunks, one fresh process a chunk.

The port's copy of the JAX package's scripts/train_chunked.py. Each chunk
is a new ``python -m count_pipnet_tpu_torch.main`` process that stops
after ``--max_epochs_per_process`` epochs, writing
``checkpoints/CHUNK_CONTINUE`` beside the resumable ``net_trained_last``.
This wrapper re-invokes it with ``--resume_training`` until the marker
is gone (the run is complete) or a chunk fails. A chunk whose
``<log_dir>/out.txt`` stops growing is killed and retried (a stall
watchdog). Use it where one process may not outlive the whole run: a
time limit on each job, or a long run that should survive a lost process.

    python -m count_pipnet_tpu_torch.scripts.train_chunked \
        --chunk_epochs 20 -- --config configs/flagship_200_fast.yaml \
        [more CLI flags]
"""

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

from ..config import _apply_yaml_defaults, build_parser

REPO = str(Path(__file__).resolve().parents[2])


def log_dir_of(args_list):
    """``--log_dir`` of a CLI argument list (a flag wins over the YAML
    file, as in the parser)."""
    parser = build_parser()
    ns, _ = parser.parse_known_args(args_list)
    if getattr(ns, "config", None):
        _apply_yaml_defaults(parser, ns.config)
        ns, _ = parser.parse_known_args(args_list)
    return ns.log_dir


def _run_watched(cmd, tee_path, stall_timeout, poll_s=15.0, env=None):
    """subprocess.call with a stall watchdog: if the run's tee file
    (``tee_path``) stops growing for ``stall_timeout`` seconds while the
    child is alive, the child is taken as hung: kill it and report
    ``(rc, stalled=True)``."""
    child = subprocess.Popen(cmd, env=env)
    if stall_timeout <= 0:
        return child.wait(), False
    last_size, last_change = -1, time.time()
    while True:
        try:
            return child.wait(timeout=poll_s), False
        except subprocess.TimeoutExpired:
            pass
        try:
            size = os.path.getsize(tee_path)
        except OSError:
            size = -1
        if size != last_size:
            last_size, last_change = size, time.time()
        elif time.time() - last_change > stall_timeout:
            print(f"[train_chunked] no output for "
                  f"{stall_timeout:.0f}s — killing stalled "
                  f"chunk (pid {child.pid})", flush=True)
            child.kill()
            child.wait()
            return -1, True


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--chunk_epochs", type=int, default=20,
                    help="main epochs per process (pretraining counts "
                         "against the first)")
    ap.add_argument("--max_chunks", type=int, default=50,
                    help="safety bound on re-invocations")
    ap.add_argument("--chunk_cooldown", type=float, default=30.0,
                    help="seconds to wait between chunks, so that the "
                         "exited chunk has released the card")
    ap.add_argument("--stall_timeout", type=float, default=1200.0,
                    help="kill + retry a chunk whose stdout tee "
                         "(log_dir/out.txt) stops growing for this many "
                         "seconds; 0 disables. Keep above the run's "
                         "longest silent stretch (the kernels' build and "
                         "the first step, a visualisation)")
    ap.add_argument("--stall_retries", type=int, default=2,
                    help="max kill+retry cycles per chunk before "
                         "giving up")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="-- followed by the CLI's arguments")
    opts = ap.parse_args(argv)
    rest = opts.rest
    if rest and rest[0] == "--":
        rest = rest[1:]
    if not rest:
        ap.error("pass the CLI's arguments after --")

    log_dir = log_dir_of(rest)
    marker = os.path.join(log_dir, "checkpoints", "CHUNK_CONTINUE")
    base = [sys.executable, "-m", "count_pipnet_tpu_torch.main", *rest,
            "--max_epochs_per_process", str(opts.chunk_epochs)]
    tee_path = os.path.join(log_dir, "out.txt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)

    def run_watched(cmd):
        return _run_watched(cmd, tee_path, opts.stall_timeout, env=env)

    for chunk in range(opts.max_chunks):
        cmd = list(base)
        if chunk > 0 or os.path.exists(marker):
            cmd.append("--resume_training")
        retries = opts.stall_retries
        while True:
            print(f"[train_chunked] chunk {chunk}: {' '.join(cmd)}",
                  flush=True)
            rc, stalled = run_watched(cmd)
            if stalled and retries > 0:
                retries -= 1
                print(f"[train_chunked] retrying chunk {chunk} after "
                      f"cooldown ({retries} retries left)", flush=True)
                time.sleep(max(opts.chunk_cooldown, 60.0))
                if "--resume_training" not in cmd and (
                        os.path.exists(marker) or os.path.isdir(
                            os.path.join(log_dir, "checkpoints"))):
                    cmd.append("--resume_training")
                continue
            break
        if rc != 0:
            print(f"[train_chunked] chunk {chunk} failed rc={rc}",
                  flush=True)
            return rc
        if not os.path.exists(marker):
            print("[train_chunked] run complete", flush=True)
            return 0
        if opts.chunk_cooldown > 0:
            time.sleep(opts.chunk_cooldown)
    print("[train_chunked] max_chunks reached with work remaining",
          flush=True)
    return 2


if __name__ == "__main__":
    sys.exit(main())
