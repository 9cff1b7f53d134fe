"""Paired arms of a config's early main epochs, resumed from shared chunks.

For each seed a first chunk runs the port's CLI (``python -m
count_pipnet_tpu_torch.main --config <config>``) with
``--max_epochs_per_process <pretrain epochs + 1>``: the whole pretraining
and main epoch 1. Its ``net_trained_last`` then holds the annealed Gumbel
temperature and the random streams. Each arm copies that run directory and
resumes it with ``--resume_training --max_epochs_per_process 5``:
main epochs 2-6. ``--epochs`` stays the config's, so the cosine and the
warm restarts are the run's own. So the arms of a seed share their
pretraining and their streams, and differ only in what the arm changes:

    control  the config as written
    f32      ``--dtype float32``
    plain    ``fused_blocks: false`` (the plain autograd blocks)
    gumbel   the Gumbel noise drawn as ``-log(-log U)`` from ``torch.rand``
             (the JAX package's form, ``jax.random.gumbel``) in place of
             ``ops/gumbel.py: sample_gumbel``
    stem_f32 ``models/convnext.py: LayerNorm2d`` returning f32 under
             autocast, as before the trunk's stream was kept in bf16: on
             CUDA the stem then hands stage 1 an f32 stream

``--arms`` runs a subset (the control always runs).

Each run is a process of this script (``--worker``). It changes nothing in
the trainer. A forward hook on the model counts, in each training batch,
the prototypes present in each view: those whose count summed over the
view's images is at least 1. The tanh loss takes about 18.4 from a
prototype with none and 1-2 from one that is present. The hook averages
the two views, and each epoch's mean is recorded. Per main epoch the
worker records the test top-1, the raw tanh and class losses, the train
accuracy, the classifier's sparsity ratio (the trainer's formula) and the
present prototypes. It writes them to ``<run>/arms_epochs.json``. The
prototype visualisations are skipped: they train nothing.

The rule: an arm moves the run when its mean over the seeds of the
epoch 2-6 tanh loss differs from the control's by more than twice the
control's seed spread, the sample standard deviation over the seeds of
each seed's mean.

    python3 -m count_pipnet_tpu_torch.scripts.paired_arms \\
        --config configs/flagship_200_wide.yaml --seeds 1 2 3 \\
        [--arms control stem_f32] [--out runs/arms] \\
        [--report runs/arms/report] [--export_seed 1] \\
        [-- <more CLI flags for every run>]

It prints one ``[arm] {...}`` JSON line a run and one ``[arms] {...}``
line with the rule applied, and copies each run's CSV, its JSON and its
``out.txt`` into ``--report``. ``--export_seed N`` also saves that seed's
first-chunk parameters that pretraining and the main phase train
(``features.6``, ``features.7``, the add-on, the intermediate, the
classifier) in bf16 to ``<report>/seed<N>_trained_bf16.pt``. The rest of
the trunk is its seeded initialisation: ``torch.manual_seed(seed)``
before the model is built, on the CPU.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ARMS = ("control", "f32", "plain", "gumbel", "stem_f32")
ARM_EPOCHS = 5  # main epochs 2-6
TRAINED_PREFIXES = ("backbone.features.6.", "backbone.features.7.",
                    "add_on.", "intermediate.", "classification.")


def loglog_gumbel(shape, generator=None, device=None):
    """Gumbel(0, 1) noise as ``-log(-log U)``, ``U`` from ``torch.rand``
    (below ``tiny`` clamped to it), as ``jax.random.gumbel`` draws it; in
    place of ``sample_gumbel`` in one process (no ``shard``)."""
    import torch
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def layer_norm_2d_f32(self, x):
    """``LayerNorm2d.forward`` without the cast to the autocast dtype."""
    import torch.nn.functional as F
    x = F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape,
                     self.weight, self.bias, self.eps)
    return x.permute(0, 3, 1, 2)


def worker(opts):
    """One run in this process: the CLI's ``_run`` on the arm's args, with
    the recording hooks around the trainer."""
    import torch
    from count_pipnet_tpu_torch import main as cli
    from count_pipnet_tpu_torch.config import get_args
    from count_pipnet_tpu_torch.models import convnext
    from count_pipnet_tpu_torch.ops import gumbel
    from count_pipnet_tpu_torch.train import trainer as tr

    argv = ["--config", opts.config, "--seed", str(opts.seed),
            "--log_dir", opts.run_dir,
            "--max_epochs_per_process", str(opts.budget),
            "--viz_prototype_maps", "False", "--viz_topk", "False"]
    argv += [a for a in opts.rest if a != "--"]
    if opts.resume:
        argv.append("--resume_training")
    if opts.worker == "f32":
        argv += ["--dtype", "float32"]
    args = get_args(argv)
    if opts.worker == "plain":
        args.fused_blocks = False
    if opts.worker == "gumbel":
        gumbel.sample_gumbel = loglog_gumbel
    if opts.worker == "stem_f32":
        convnext.LayerNorm2d.forward = layer_norm_2d_f32
    tr._visualize = lambda *a, **k: None

    acc = {"present": None, "n": 0}
    epochs = []

    def on_forward(module, inputs, output):
        if not torch.is_grad_enabled():  # the evaluation's forwards
            return
        views = output[1].detach().float().chunk(2, dim=0)
        present = sum((v.sum(dim=0) >= 1.0).sum() for v in views) / 2.0
        acc["present"] = (present if acc["present"] is None
                          else acc["present"] + present)
        acc["n"] += 1

    init, train_epoch, evaluate = (tr.Trainer.__init__,
                                   tr.Trainer.train_epoch, tr.evaluate)

    def init_hooked(self, *a, **k):
        init(self, *a, **k)
        self.model.register_forward_hook(on_forward)

    def train_epoch_hooked(self, loader, epoch, nr_epochs, **k):
        acc.update(present=None, n=0)
        info = train_epoch(self, loader, epoch, nr_epochs, **k)
        if not k.get("pretrain"):
            epochs.append({
                "epoch": epoch, "tanh": info["tanh_loss_raw"],
                "class": info["class_loss_raw"],
                "train_acc": info["train_accuracy"],
                "present": float(acc["present"]) / max(acc["n"], 1),
                "tau": self.tau})
        return info

    def evaluate_hooked(model, *a, **k):
        info = evaluate(model, *a, **k)
        w = model.classification.weight.detach().float()
        epochs[-1]["top1"] = info["top1_accuracy"]
        epochs[-1]["sparsity"] = float(
            (w.numel() - torch.count_nonzero((w - 1e-3).clamp(min=0)))
            / w.numel())
        return info

    tr.Trainer.__init__ = init_hooked
    tr.Trainer.train_epoch = train_epoch_hooked
    tr.evaluate = evaluate_hooked
    t0 = time.time()
    cli._run(args)
    with open(os.path.join(opts.run_dir, "arms_epochs.json"), "w") as f:
        json.dump({"arm": opts.worker, "seed": opts.seed,
                   "seconds": time.time() - t0, "epochs": epochs}, f)
    return 0


def run_worker(arm, config, seed, run_dir, budget, resume, rest):
    """A worker process; its printout goes to ``<run_dir>.log``."""
    cmd = [sys.executable, "-m", "count_pipnet_tpu_torch.scripts.paired_arms",
           "--worker", arm, "--config", config, "--seed", str(seed),
           "--run_dir", run_dir, "--budget", str(budget)]
    if resume:
        cmd.append("--resume")
    cmd += ["--"] + [a for a in rest if a != "--"]
    t0 = time.time()
    with open(run_dir.rstrip("/") + ".log", "w") as log:
        code = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT
                              ).returncode
    if code != 0:
        raise RuntimeError(f"{arm} seed {seed} exited {code}: see "
                           f"{run_dir}.log")
    with open(os.path.join(run_dir, "arms_epochs.json")) as f:
        res = json.load(f)
    res["wall_s"] = time.time() - t0
    return res


def export_trained(run_dir, path):
    """The first chunk's trained parameters, in bf16."""
    import torch
    state = torch.load(os.path.join(run_dir, "checkpoints",
                                    "net_trained_last"),
                       map_location="cpu", weights_only=True)["model"]
    keep = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in state.items() if k.startswith(TRAINED_PREFIXES)}
    torch.save(keep, path)
    return sum(v.numel() for v in keep.values())


def spread(xs):
    return statistics.stdev(xs) if len(xs) > 1 else 0.0


def decide(results):
    """Each arm's per-seed mean tanh loss over its epochs, the seeds' mean,
    and the rule against the control."""
    table = {}
    for arm in results:
        per_seed = {s: statistics.fmean(e["tanh"] for e in r["epochs"])
                    for s, r in results[arm].items()}
        table[arm] = {"per_seed": per_seed,
                      "mean": statistics.fmean(per_seed.values()),
                      "spread": spread(list(per_seed.values()))}
    ctrl = table["control"]
    for arm, row in table.items():
        row["diff"] = row["mean"] - ctrl["mean"]
        row["moves"] = (arm != "control"
                        and abs(row["diff"]) > 2 * ctrl["spread"])
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="configs/flagship_200_wide.yaml")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--out", default="runs/arms")
    ap.add_argument("--report", default="runs/arms/report")
    ap.add_argument("--export_seed", type=int, default=None)
    ap.add_argument("--arms", nargs="+", default=list(ARMS), choices=ARMS)
    # one run in this process (the parent starts these)
    ap.add_argument("--worker", choices=("first",) + ARMS,
                    help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--run_dir", help=argparse.SUPPRESS)
    ap.add_argument("--budget", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--resume", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="-- then flags for every run's CLI")
    opts = ap.parse_args(argv)
    if opts.worker:
        return worker(opts)

    from count_pipnet_tpu_torch.config import get_args
    pretrain = get_args(["--config", opts.config]).epochs_pretrain
    os.makedirs(opts.out, exist_ok=True)
    os.makedirs(opts.report, exist_ok=True)
    arms = ["control"] + [a for a in opts.arms if a != "control"]
    results = {arm: {} for arm in arms}
    for seed in opts.seeds:
        first = os.path.join(opts.out, f"seed{seed}_first")
        res = run_worker("first", opts.config, seed, first, pretrain + 1,
                         False, opts.rest)
        print("[arm] " + json.dumps(res), flush=True)
        _report(opts.report, first, f"seed{seed}_first")
        if seed == opts.export_seed:
            n = export_trained(first, os.path.join(
                opts.report, f"seed{seed}_trained_bf16.pt"))
            print(f"exported {n} trained parameters of seed {seed}",
                  flush=True)
        for arm in arms:
            run_dir = os.path.join(opts.out, f"seed{seed}_{arm}")
            shutil.rmtree(run_dir, ignore_errors=True)
            shutil.copytree(first, run_dir)
            res = run_worker(arm, opts.config, seed, run_dir, ARM_EPOCHS,
                             True, opts.rest)
            results[arm][seed] = res
            print("[arm] " + json.dumps(res), flush=True)
            _report(opts.report, run_dir, f"seed{seed}_{arm}")
            shutil.rmtree(os.path.join(run_dir, "checkpoints"),
                          ignore_errors=True)
    table = decide(results)
    print("[arms] " + json.dumps(table), flush=True)
    with open(os.path.join(opts.report, "arms.json"), "w") as f:
        json.dump({"table": table, "runs": results}, f, indent=1)
    return 0


def _report(report, run_dir, name):
    """A run's small files into the report directory."""
    for src, dst in (("log_epoch_overview.csv", ".csv"),
                     ("arms_epochs.json", ".json"), ("out.txt", ".out.txt")):
        path = os.path.join(run_dir, src)
        if os.path.exists(path):
            shutil.copy(path, os.path.join(report, name + dst))


if __name__ == "__main__":
    sys.exit(main())
