"""The canonical shapes experiment trained through the port, seed by seed.

For each seed N it runs the port's CLI in this process, as

    python -m count_pipnet_tpu_torch.main \
        --config configs/sweep_r2/onehot_seedN.yaml \
        --log_dir <out>/accept_onehot_seedN --viz_prototype_maps False

does (the configs as written: 9-class noisy shapes at 192², a 3-stage
ConvNeXt, 16 prototypes, onehot, ``--fused_blocks --device_augment``,
10 + 100 epochs; the prototype maps need matplotlib, which the card's
machine lacks), with the launch counts of the port's kernels set to 0
before the run and read after it. Then it prints one line a seed (the
run's wall time, the kernels it launched, best and last top-1, the local
size and the nonzero prototypes at the best epoch, the median epoch time
of the main phase, the two visualisations' wall times, the step times
below) and reads the runs with ``notebooks/evaluate_runs.py``.

Step times (``steps``): the trainer's epoch and step are wrapped for the
run. The host clock marks each ``train_step`` call and return (no
synchronisation), so that in the steady main phase (the epochs after the
trunk unfreezes) the median interval between two returns of one epoch is
the steady step, split into the host time inside ``train_step`` and the
time before it (the loader's next batch, the device augmentation's
enqueue, the schedule); an epoch's start-up (from its start to its first
step) and tail (from its last step to its end, which synchronises) are
given apart. One steady epoch (``PROFILE_AFTER_FREEZE`` after the
unfreeze) runs under ``torch.profiler`` with CUDA activity only: its wall
time between two synchronisations, the kernels' summed device time, the
idle share, and the five kernels that take the most device time.

    python3 -m count_pipnet_tpu_torch.scripts.acceptance_run \
        [--seeds 1 2 3] [--out chiprun_out] [--drop_checkpoints] \
        [-- <more CLI flags>]

Flags after ``--`` go to the CLI, e.g. ``-- --dtype float32``.
``--drop_checkpoints`` removes each run's ``checkpoints/`` once it is
read (about 50 MB a run).
"""

import argparse
import csv
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONFIG = "configs/sweep_r2/onehot_seed{}.yaml"
EPOCH_TIME = re.compile(r"Epoch time: ([0-9.]+)s \(([0-9.]+) steps/s\)")
VIS_TIME = re.compile(r"^\s*(.*visualization) took ([0-9.]+)s")
# the profiled epoch: this many main epochs after the trunk unfreezes
PROFILE_AFTER_FREEZE = 2


def card_line():
    """``name, power.limit`` of the card as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"(nvidia-smi unavailable: {e})"


def read_csv(run_dir):
    """The main phase's rows of ``log_epoch_overview.csv`` as floats."""
    rows = []
    with open(os.path.join(run_dir, "log_epoch_overview.csv")) as f:
        for row in csv.DictReader(f):
            if row["test_top1_acc"] in ("n.a.", ""):
                continue
            rows.append({k: float(v) for k, v in row.items()
                         if v not in ("n.a.", "")})
    return rows


def read_log(run_dir):
    """Epoch times of each phase and the visualisations' wall times, from
    the run's ``out.txt``."""
    pre, main, vis = [], [], {}
    phase = pre
    with open(os.path.join(run_dir, "out.txt")) as f:
        for line in f:
            if "Pretrain Epoch" in line:
                phase = pre
            elif re.match(r"\s*Epoch \d+ finetune", line):
                phase = main
            m = EPOCH_TIME.search(line)
            if m:
                phase.append((float(m.group(1)), float(m.group(2))))
            m = VIS_TIME.match(line)
            if m:
                vis[m.group(1)] = float(m.group(2))
    return pre, main, vis


def summarize(run_dir, freeze_epochs):
    rows = read_csv(run_dir)
    best = max(rows, key=lambda r: r["test_top1_acc"])
    pre, main, vis = read_log(run_dir)
    # the steady state: the main phase once the frozen stage has joined
    steady = main[freeze_epochs:] or main
    return {
        "best_top1": best["test_top1_acc"], "best_epoch": int(best["epoch"]),
        "last_top1": rows[-1]["test_top1_acc"],
        "local_size_true": best.get("local_size_for_true_class"),
        "protos_per_class": best.get("prototypes_per_class"),
        "nonzero_protos": best.get("num_nonzero_prototypes"),
        "main_epochs": len(main), "pretrain_epochs": len(pre),
        "epoch_s_median": statistics.median(t for t, _ in steady),
        "epoch_s_first": main[0][0] if main else None,
        "pretrain_epoch_s_median": (statistics.median(t for t, _ in pre)
                                    if pre else None),
        "visualization_s": vis,
    }


def step_times(epochs, freeze_epochs, skip=()):
    """Medians in ms over the steady main epochs (after ``freeze_epochs``,
    none of ``skip``) of ``epochs``: {(phase, epoch): (begin, [(call,
    return), ...], end)} on the host clock, in seconds."""
    interval, inside, before, start, tail = [], [], [], [], []
    for (phase, epoch), (begin, marks, end) in epochs.items():
        if phase != "main" or epoch <= freeze_epochs or epoch in skip \
                or not marks:
            continue
        start.append(marks[0][0] - begin)
        tail.append(end - marks[-1][1])
        for (_, prev), (call, ret) in zip(marks, marks[1:]):
            interval.append(ret - prev)
            inside.append(ret - call)
            before.append(call - prev)
    if not interval:
        return None

    def ms(v):
        return round(1e3 * statistics.median(v), 3)
    return {"steady_epochs": len(start), "step_ms": ms(interval),
            "in_train_step_ms": ms(inside), "before_step_ms": ms(before),
            "epoch_start_ms": ms(start), "epoch_tail_ms": ms(tail)}


def device_us(e):
    """An averaged profiler event's own device time in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        t = getattr(e, attr, None)
        if t is not None:
            return t
    return 0.0


class Instrument:
    """Wraps ``Trainer.train_epoch`` and the trainer's ``train_step`` for
    one run: the host-clock marks of ``step_times`` and, on the card, a
    CUDA-only profile of main epoch ``profile_epoch``. ``close`` undoes
    the wrapping."""

    def __init__(self, profile_epoch):
        from ..train import trainer as trainer_mod
        self.mod, self.profile_epoch = trainer_mod, profile_epoch
        self.epochs, self.profile, self.key = {}, None, None
        epoch_fn = trainer_mod.Trainer.train_epoch
        step_fn = trainer_mod.train_step
        self.saved = (epoch_fn, step_fn)

        def train_step(*a, **kw):
            call = time.perf_counter()
            out = step_fn(*a, **kw)
            self.epochs[self.key][1].append((call, time.perf_counter()))
            return out

        def train_epoch(trainer, loader, epoch, nr_epochs, *, pretrain,
                        **kw):
            self.key = ("pretrain" if pretrain else "main", epoch)
            if (pretrain or epoch != self.profile_epoch
                    or trainer.device.type != "cuda"):
                return self._timed(epoch_fn, trainer, loader, epoch,
                                   nr_epochs, pretrain=pretrain, **kw)
            import torch
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                info = self._timed(epoch_fn, trainer, loader, epoch,
                                   nr_epochs, pretrain=pretrain, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            self.profile = self.read_profile(prof, epoch, wall,
                                             len(self.epochs[self.key][1]))
            return info

        trainer_mod.Trainer.train_epoch = train_epoch
        trainer_mod.train_step = train_step

    def _timed(self, fn, *a, **kw):
        begin, marks = time.perf_counter(), []
        self.epochs[self.key] = (begin, marks, None)
        info = fn(*a, **kw)
        self.epochs[self.key] = (begin, marks, time.perf_counter())
        return info

    @staticmethod
    def read_profile(prof, epoch, wall, steps):
        kernels = [(e.key, device_us(e), e.count)
                   for e in prof.key_averages() if device_us(e) > 0]
        busy = sum(us for _, us, _ in kernels) / 1e3
        kernels.sort(key=lambda k: -k[1])
        return {
            "epoch": epoch, "steps": steps, "wall_ms": round(wall * 1e3, 3),
            "device_busy_ms": round(busy, 3),
            "device_ms_per_step": round(busy / max(steps, 1), 3),
            "idle_share": round(1.0 - busy / (wall * 1e3), 4),
            "top_kernels": [
                {"name": k[:80], "ms": round(us / 1e3, 3), "calls": n}
                for k, us, n in kernels[:5]]}

    def close(self):
        self.mod.Trainer.train_epoch, self.mod.train_step = self.saved


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--drop_checkpoints", action="store_true")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="-- followed by more CLI flags")
    opts = ap.parse_args(argv)
    rest = opts.rest[1:] if opts.rest[:1] == ["--"] else opts.rest

    import torch
    from torch.distributed import constants

    from .. import main as cli
    from ..ops import cuda as kernels

    os.makedirs(opts.out, exist_ok=True)
    print(f"card: {card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"default_pg_timeout {constants.default_pg_timeout}, "
          "default_pg_nccl_timeout "
          f"{getattr(constants, 'default_pg_nccl_timeout', None)}",
          flush=True)
    run_dirs, results = [], []
    for seed in opts.seeds:
        run_dir = os.path.join(opts.out, f"accept_onehot_seed{seed}")
        argv_run = ["--config", str(REPO / CONFIG.format(seed)),
                    "--log_dir", run_dir, "--viz_prototype_maps", "False",
                    *rest]
        args = cli.get_args(argv_run)
        freeze = args.freeze_epochs + args.epochs_finetune
        print(f"[accept] seed {seed}: main {' '.join(argv_run)}",
              flush=True)
        inst = Instrument(min(freeze + PROFILE_AFTER_FREEZE, args.epochs))
        kernels.reset_launch_counts()
        t0 = time.time()
        try:
            rc = cli.main(argv_run)
        finally:
            inst.close()
        wall = time.time() - t0
        launches = {k: v for k, v in kernels.launch_counts.items() if v}
        if rc:
            print(f"[accept] seed {seed} failed rc={rc}", flush=True)
            return rc
        res = {"seed": seed, "run_dir": run_dir, "wall_s": round(wall, 1),
               "launches": launches, **summarize(run_dir, freeze),
               "steps": step_times(inst.epochs, freeze,
                                   skip=(inst.profile_epoch,)),
               "profiled_epoch": inst.profile}
        results.append(res)
        run_dirs.append(run_dir)
        print("[accept] " + json.dumps(res), flush=True)
        if opts.drop_checkpoints:
            shutil.rmtree(os.path.join(run_dir, "checkpoints"),
                          ignore_errors=True)
    best = [r["best_top1"] for r in results]
    print("[accept] " + json.dumps({
        "seeds": opts.seeds, "best_top1_mean": statistics.mean(best),
        "best_top1_std": statistics.pstdev(best),
        "card": card_line()}), flush=True)
    evaluator = REPO / "notebooks" / "evaluate_runs.py"
    if evaluator.exists():
        subprocess.run([sys.executable, str(evaluator), "--run_dirs",
                        *run_dirs, "--out_dir",
                        os.path.join(opts.out, "accept_onehot_eval")],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
