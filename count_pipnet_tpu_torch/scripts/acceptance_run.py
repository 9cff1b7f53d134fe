"""Acceptance runs: a config trained through the port, seed by seed, and
optionally its checkpoint served on every gumbel route.

For each seed N it runs the port's CLI in this process, as

    python -m count_pipnet_tpu_torch.main --config <config> \
        --log_dir <out>/accept_<name>_seedN --viz_prototype_maps False

does (the prototype maps need matplotlib, which the card's machine lacks;
the top-k grids render), with the launch counts of the port's kernels set
to 0 before the run and read after it. The default config is the
canonical shapes experiment, ``configs/sweep_r2/onehot_seed{N}.yaml`` (a
``{}`` in ``--config`` takes the seed: 9-class noisy shapes at 192², a
3-stage ConvNeXt, 16 prototypes, onehot, ``--fused_blocks
--device_augment``, 10 + 100 epochs); any other config runs as written,
with ``--seed N`` added only where N is not its own seed (e.g.
``configs/flagship_200_wide.yaml``: 200 classes at 224², 7 stages, 256
prototypes, a trunk that never unfreezes). Then it prints one line a seed
(the run's wall time, the kernels it launched, best and last top-1, the
local size and the nonzero prototypes at the best epoch, the median epoch
time of the steady main phase, the two visualisations' wall times, the
step times below) and reads the runs with ``notebooks/evaluate_runs.py``.
A seed fails, rather than reports, when either visualisation printed
``(... skipped: ...)`` or when K5 or K6 never launched.

Step times (``steps``): the trainer's epoch and step are wrapped for the
run. The host clock marks each ``train_step`` call and return (no
synchronisation), so that in the steady main phase the median interval
between two returns of one epoch is the steady step, split into the host
time inside ``train_step`` and the time before it (the loader's next
batch, the device augmentation's enqueue, the schedule); an epoch's
start-up (from its start to its first step) and tail (from its last step
to its end, which synchronises) are given apart. The steady main phase is
the epochs after the trunk unfreezes, or, in a schedule that never
unfreezes it, the epochs after the first ``STEADY_AFTER``
(:func:`schedule`). One steady epoch (``PROFILE_AFTER`` after the
unfreeze, or main epoch ``PROFILE_FROZEN``) runs under ``torch.profiler``
with CUDA activity only: its wall time between two synchronisations, the kernels'
summed device time, the idle share, and the five kernels that take the
most device time.

``--serve`` then serves each run's ``net_best`` on the four gumbel routes
over its whole test split (scripts/serve_trained.py), before
``--drop_checkpoints`` removes the run's ``checkpoints/`` (about 50 MB a
canonical run, many times that for the 7-stage flagship); a serving fault
fails the seed.

    python3 -m count_pipnet_tpu_torch.scripts.acceptance_run \
        [--config configs/flagship_200_wide.yaml] \
        [--seeds 1 2 3] [--out chiprun_out] [--serve] [--drop_checkpoints] \
        [-- <more CLI flags>]

Flags after ``--`` go to the CLI, e.g. ``-- --dtype float32``.
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

from . import card_line

REPO = Path(__file__).resolve().parents[2]
CONFIG = "configs/sweep_r2/onehot_seed{}.yaml"
EPOCH_TIME = re.compile(r"Epoch time: ([0-9.]+)s \(([0-9.]+) steps/s\)")
VIS_TIME = re.compile(r"^\s*(.*visualization) took ([0-9.]+)s")
VIS_SKIPPED = re.compile(r"^\s*\((.*visualization) skipped: (.*)\)\s*$")
# the profiled epoch: this many main epochs after the trunk unfreezes
PROFILE_AFTER = 2
# a schedule that never unfreezes the trunk: the steady main phase starts
# after this many main epochs, and this main epoch is profiled (the
# canonical experiment's: 10 frozen epochs, then 2)
STEADY_AFTER = 2
PROFILE_FROZEN = 12
# the launch counts of K5 and K6, each of which every training run of the
# acceptance configs (--fused_blocks) must launch
TRAINING_KERNELS = ("fused_ln_mlp_residual", "fused_mlp_bwd")


def schedule(freeze_epochs, epochs):
    """(the main epochs before the steady phase, the profiled main epoch)
    of a run whose trunk unfreezes after ``freeze_epochs`` of its
    ``epochs`` main epochs; a trunk that never unfreezes (``freeze_epochs
    >= epochs``) takes the steady phase after ``STEADY_AFTER`` epochs and
    profiles main epoch ``PROFILE_FROZEN``."""
    if freeze_epochs >= epochs:
        return STEADY_AFTER, min(PROFILE_FROZEN, epochs)
    return freeze_epochs, min(freeze_epochs + PROFILE_AFTER, epochs)


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
    """Epoch times of each phase, the visualisations' wall times and the
    visualisations that were skipped (with their errors), from the run's
    ``out.txt``."""
    pre, main, vis, skipped = [], [], {}, {}
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
            m = VIS_SKIPPED.match(line)
            if m:
                skipped[m.group(1)] = m.group(2)
    return pre, main, vis, skipped


def summarize(run_dir, steady_after):
    """The run's figures from its CSV and ``out.txt``; the epoch times of
    the steady main phase are those after ``steady_after`` main epochs."""
    rows = read_csv(run_dir)
    best = max(rows, key=lambda r: r["test_top1_acc"])
    pre, main, vis, skipped = read_log(run_dir)
    steady = main[steady_after:] or main
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
        "visualization_s": vis, "visualization_skipped": skipped,
    }


def step_times(epochs, steady_after, skip=()):
    """Medians in ms over the steady main epochs (after ``steady_after``,
    none of ``skip``) of ``epochs``: {(phase, epoch): (begin, [(call,
    return), ...], end)} on the host clock, in seconds."""
    interval, inside, before, start, tail = [], [], [], [], []
    for (phase, epoch), (begin, marks, end) in epochs.items():
        if phase != "main" or epoch <= steady_after or epoch in skip \
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


def run_faults(res):
    """Why a finished seed fails rather than reports: a visualisation that
    was skipped, or K5 or K6 never launched."""
    faults = [f"{what} skipped: {err}"
              for what, err in res["visualization_skipped"].items()]
    faults += [f"{k} launched 0 times" for k in TRAINING_KERNELS
               if not res["launches"].get(k)]
    return faults


def run_argv(config, seed, run_dir, rest, get_args):
    """The CLI's flags of one seed: ``config`` (its ``{}`` takes the seed,
    else ``--seed`` is added where the config's own seed differs),
    ``--log_dir``, ``--viz_prototype_maps False`` and ``rest``."""
    path = Path(config.format(seed))
    argv = ["--config", str(path if path.is_absolute() else REPO / path),
            "--log_dir", run_dir, "--viz_prototype_maps", "False", *rest]
    if "{}" not in config and get_args(argv).seed != seed:
        argv += ["--seed", str(seed)]
    return argv


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=CONFIG,
                    help="the config, relative to the repository; a {} in "
                    "it takes the seed (default: %(default)s)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--serve", action="store_true",
                    help="serve each run's net_best on the four gumbel "
                    "routes (scripts/serve_trained.py)")
    ap.add_argument("--drop_checkpoints", action="store_true")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="-- followed by more CLI flags")
    opts = ap.parse_args(argv)
    rest = opts.rest[1:] if opts.rest[:1] == ["--"] else opts.rest
    # runs go to <out>/<run_name>_seed<N>
    run_name = ("accept_onehot" if opts.config == CONFIG
                else "accept_" + Path(opts.config).stem)

    import torch
    from torch.distributed import constants

    from .. import main as cli
    from ..ops import cuda as kernels
    from .serve_trained import serve_trained

    os.makedirs(opts.out, exist_ok=True)
    print(f"card: {card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"default_pg_timeout {constants.default_pg_timeout}, "
          "default_pg_nccl_timeout "
          f"{getattr(constants, 'default_pg_nccl_timeout', None)}",
          flush=True)
    run_dirs, results = [], []
    for seed in opts.seeds:
        run_dir = os.path.join(opts.out, f"{run_name}_seed{seed}")
        argv_run = run_argv(opts.config, seed, run_dir, rest, cli.get_args)
        args = cli.get_args(argv_run)
        steady_after, profile_epoch = schedule(
            args.freeze_epochs + args.epochs_finetune, args.epochs)
        print(f"[accept] seed {seed}: main {' '.join(argv_run)}",
              flush=True)
        inst = Instrument(profile_epoch)
        kernels.reset_launch_counts()
        t0 = time.time()
        try:
            try:
                rc = cli.main(argv_run)
            finally:
                inst.close()
            wall = time.time() - t0
            launches = {k: v for k, v in kernels.launch_counts.items() if v}
            if rc:
                print(f"[accept] seed {seed} failed rc={rc}", flush=True)
                return rc
            res = {"seed": seed, "run_dir": run_dir,
                   "wall_s": round(wall, 1), "launches": launches,
                   **summarize(run_dir, steady_after),
                   "steps": step_times(inst.epochs, steady_after,
                                       skip=(inst.profile_epoch,)),
                   "profiled_epoch": inst.profile}
            print("[accept] " + json.dumps(res), flush=True)
            faults = run_faults(res)
            if faults:
                print(f"[accept] seed {seed} failed: {'; '.join(faults)}",
                      flush=True)
                return 1
            if opts.serve:
                t0 = time.time()
                serve_trained(run_dir, device="cpu" if args.disable_cuda
                              else "cuda", batch_size=args.batch_size)
                res["serve_s"] = round(time.time() - t0, 1)
        finally:
            if opts.drop_checkpoints:
                shutil.rmtree(os.path.join(run_dir, "checkpoints"),
                              ignore_errors=True)
        results.append(res)
        run_dirs.append(run_dir)
    best = [r["best_top1"] for r in results]
    print("[accept] " + json.dumps({
        "seeds": opts.seeds, "best_top1_mean": statistics.mean(best),
        "best_top1_std": statistics.pstdev(best),
        "serve_s": [r.get("serve_s") for r in results],
        "card": card_line()}), flush=True)
    evaluator = REPO / "notebooks" / "evaluate_runs.py"
    if evaluator.exists():
        subprocess.run([sys.executable, str(evaluator), "--run_dirs",
                        *run_dirs, "--out_dir",
                        os.path.join(opts.out, f"{run_name}_eval")],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
