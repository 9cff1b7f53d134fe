"""Two-phase training: the reference ``run_pipnet`` (main.py:42-496).

Port of count_pipnet_tpu/train/trainer.py. Phase structure:

* Phase 1 (prototype pretraining, main.py:238-295): align weight ramps
  epoch/nr_epochs, tanh weight 5, class weight 0; classifier frozen, the
  early backbone frozen; Count-PIPNet's Gumbel tau annealed 1.0 -> 0.1
  with a 25 % stabilisation tail; net LR on a per-iteration cosine
  (T_max = len(loader) * epochs, eta_min = lr_block / 100). Then the
  prototypes are visualised (interpret/vis_pipnet.py).
* Phase 2 (main.py:305-437): fresh optimizer state; align 5 / tanh 2 /
  class 2; a finetune window (classifier only) for the first
  ``epochs_finetune`` epochs; the backbone unfreezes after
  ``freeze_epochs + epochs_finetune``; weight zeroing every 30 epochs and
  at the last; Count-PIPNet without STE trains the classifier only;
  per-epoch evaluation, CSV row and checkpoints; classifier LR on warm
  restarts (T_0 = 5 or 10, eta_min 1e-3) with fractional epoch stepping;
  the best checkpoint's prototypes visualised at the end; with
  ``--interpret`` the interpretability suite on that model (``_interpret``).

``--model count_pipnet`` builds a Count-PIPNet, any other value the
PIP-Net (models/pipnet.py), as in the JAX package.

A phase's trainable groups become ``requires_grad`` (optim.set_trainable),
so autograd computes no backward for what is frozen. ``--dtype bfloat16``
runs the forward under ``torch.autocast`` with f32 parameters. A loader
that carries a ``device_augment_cfg`` (``--device_augment``) yields
single-view batches; both views are made on the device
(data/device_augment.py) from a generator of their own.

``--mesh_shape N`` trains data-parallel on N ranks (main.py spawns them,
or torchrun starts them): the trainer builds the world's mesh on this
rank's device, replicates rank 0's state at the start and after every
load, and each step equals the one-process step on the joined batch
(train/steps.py). Every rank evaluates the whole test set; only rank 0
writes files (the CSV, checkpoints, ``metadata/``, the visualisations,
``--interpret``), and the ranks meet at a barrier before reading
``net_best``.
"""

import os
import time
from typing import Dict, Optional

import torch

from ..config import save_args
from ..data.device_augment import make_device_twoview_augment
from ..models.pipnet import get_count_network, get_pipnet
from ..parallel import distributed
from ..parallel.mesh import BatchShard, make_mesh, replicate
from ..utils.checkpoint import (CheckpointManager, find_shared_backbone,
                                graft_pretrained, load_backbone_only)
from ..utils.log import Log
from .eval import class_prototype_weights, evaluate
from .optim import (cosine_lr, label_params, load_adamw_by_name,
                    make_optimizer, masks_of, set_trainable, warm_restart_lr)
from .steps import autocast_for, train_step

__all__ = ["run_pipnet", "Trainer", "check_ported", "restore_initial_state",
           "LOG_COLUMNS"]

LOG_COLUMNS = (
    "test_top1_acc", "local_size_for_true_class",
    "local_size_for_all_classes", "prototypes_per_class",
    "almost_nonzeros_pooled", "num_nonzero_prototypes", "mean_train_acc",
    "mean_train_loss_during_epoch", "align_loss_raw", "tanh_loss_raw",
    "class_loss_raw", "align_loss_weighted", "tanh_loss_weighted",
    "class_loss_weighted",
)
_METRICS = ("loss", "acc", "align", "tanh", "class", "align_weighted",
            "tanh_weighted", "class_weighted")


# (a test of args, what it needs): the flags whose path the port does not
# carry, each naming its ROADMAP Queue 1 item by title. Empty: every flag
# of the JAX package's CLI is ported.
UNPORTED = ()


def check_ported(args):
    """Raise ``NotImplementedError`` for a flag of :data:`UNPORTED`."""
    for bad, what in UNPORTED:
        if bad(args):
            raise NotImplementedError(
                f"{what} is not ported to PyTorch yet")


class Trainer:
    """The model, its optimizer and the phase schedules of one run."""

    def __init__(self, args, num_classes: int, classes=None, device=None):
        self.args = args
        self.num_classes = num_classes
        self.classes = classes
        if device is None:
            device = distributed.device()  # a rank's own device
        if device is None:
            device = ("cpu" if getattr(args, "disable_cuda", False) else
                      torch.device("cuda", torch.cuda.current_device()))
        self.device = torch.device(device)
        self.mesh = make_mesh(getattr(args, "mesh_shape", -1), self.device)
        self.dtype = getattr(args, "dtype", "bfloat16")
        self.is_count = getattr(args, "model", "pipnet") == "count_pipnet"
        self.use_gumbel = (getattr(args, "activation", "gumbel_softmax")
                           == "gumbel_softmax")
        torch.manual_seed(args.seed)
        if self.is_count:
            self.model, self.num_prototypes = get_count_network(
                num_classes, args, max_count=getattr(args, "max_count", 3),
                use_ste=getattr(args, "use_ste", False))
        else:
            self.model, self.num_prototypes = get_pipnet(num_classes, args)
        self._classifier_init()
        self.model.to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(args.seed)
        # the views' draws: a stream apart from the model's (stochastic
        # depth, Gumbel noise), so the two are not correlated
        self.aug_generator = torch.Generator(self.device).manual_seed(
            args.seed + 1)
        # the main phase's evaluation draws (the Gumbel noise of the test
        # pass)
        self.eval_generator = torch.Generator(self.device).manual_seed(
            args.seed + 7)
        self.tau = 1.0
        self.labels = label_params(
            self.model, args.net,
            use_mid_layers=getattr(args, "use_mid_layers", False),
            num_stages=getattr(args, "num_stages", 2),
            train_intermediate=getattr(args, "train_intermediate", True),
            bias=getattr(args, "bias", False))
        self.reinit_optimizers()
        self.replicate()

    def replicate(self):
        """Rank 0's model and optimizer state on every rank (a no-op in
        one process)."""
        replicate(self.mesh, self.model, self.optimizer)

    def _classifier_init(self):
        """Reference classifier init (main.py:166-172): weight ~
        N(1.0, 0.1), multiplier 2 (never trained), bias 0."""
        clf = self.model.classification
        with torch.no_grad():
            clf.weight.normal_(1.0, 0.1)
            clf.normalization_multiplier.fill_(2.0)
            if clf.bias is not None:
                clf.bias.zero_()

    def rng_state(self) -> Dict:
        """The states of the run's random streams (saved with
        ``net_trained``)."""
        return {name: getattr(self, name).get_state()
                for name in ("generator", "aug_generator", "eval_generator")}

    def set_rng_state(self, states: Dict):
        """Restore :meth:`rng_state`'s states; one saved on another device
        type (a CPU run resumed on the card) leaves its stream fresh."""
        for name, state in states.items():
            gen = getattr(self, name)
            if state.numel() == gen.get_state().numel():
                gen.set_state(state)
            else:
                print(f"({name} not restored: saved on another device "
                      "type)", flush=True)

    def reinit_optimizers(self):
        """Fresh AdamW state (the reference re-creates both optimizers at
        the phase-2 boundary, main.py:305-308)."""
        self.optimizer = make_optimizer(self.model, self.labels,
                                        self.args.weight_decay)

    def to_device(self, x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @torch.no_grad()
    def probe_wshape(self, loader) -> int:
        """One forward to record the latent grid size
        (reference main.py:211-218)."""
        xs1 = next(iter(loader))[0][:1]
        cfg = getattr(loader, "device_augment_cfg", None)
        if cfg is not None:  # single-view uint8 batches: make a view
            gen = torch.Generator(self.device).manual_seed(self.args.seed)
            xs1, _ = make_device_twoview_augment(cfg)(
                gen, torch.as_tensor(xs1, device=self.device))
        xs1 = self.to_device(xs1)
        with autocast_for(self.device, self.dtype):
            proto, _, _ = self.model(xs1, generator=self.generator)
        self.args.wshape = proto.shape[2]
        print("Output shape:", tuple(proto.shape), flush=True)
        return self.args.wshape

    # -- per-epoch masks ----------------------------------------------------
    def pretrain_masks(self):
        return masks_of({"to_train", "to_freeze", "add_on"})

    def main_masks(self, epoch: int, epochs_to_finetune: int,
                   freeze_epochs: int):
        """main.py:333-390."""
        count_no_ste = self.is_count and not getattr(self.args, "use_ste",
                                                     False)
        if epoch <= epochs_to_finetune:
            labels, finetune = {"cls_weight", "cls_bias", "intermediate"}, True
        elif count_no_ste:
            labels, finetune = {"cls_weight", "cls_bias"}, False
        elif epoch <= freeze_epochs:
            labels = {"to_train", "to_freeze", "add_on", "intermediate",
                      "cls_weight", "cls_bias"}
            finetune = False
        else:
            labels = {"backbone", "to_train", "to_freeze", "add_on",
                      "intermediate", "cls_weight", "cls_bias"}
            finetune = False
        if not getattr(self.args, "train_intermediate", True):
            labels.discard("intermediate")
        return masks_of(labels), finetune

    def sched(self, i, iters, epoch, *, pretrain, finetune, net_sched,
              cls_sched, bb_warmup, weights):
        """The step's ``sched`` dict (see train/steps.py)."""
        args = self.args
        f, t, eta = net_sched["step"], net_sched["T"], net_sched["eta_min"]
        lr = {"backbone": cosine_lr(args.lr_net, f, t, eta),
              "to_freeze": cosine_lr(args.lr_block, f, t, eta),
              "to_train": cosine_lr(args.lr_block, f, t, eta),
              "add_on": cosine_lr(args.lr_block * 10.0, f, t, eta)}
        if bb_warmup is not None and not pretrain:
            fz, nwu = bb_warmup
            if nwu > 0 and epoch > fz:
                prog = (epoch - 1 - fz + i / max(iters, 1)) / nwu
                lr["backbone"] *= min(1.0, max(0.0, prog))
        lr_cls = 0.0
        if cls_sched is not None and not pretrain:
            lr_cls = warm_restart_lr(args.lr, epoch - 1 + i / max(iters, 1),
                                     cls_sched["T0"], cls_sched["eta_min"])
        lr.update(cls_weight=lr_cls, cls_bias=lr_cls, intermediate=lr_cls)
        align_w, t_w, cl_w = weights
        return {"lr": lr, "align_w": align_w, "tanh_w": t_w,
                "class_w": cl_w, "pretrain": 1.0 if pretrain else 0.0,
                "finetune": 1.0 if finetune else 0.0, "tau": self.tau,
                "project": 0.0 if pretrain else 1.0}

    # -- epoch loop ---------------------------------------------------------
    def train_epoch(self, loader, epoch: int, nr_epochs: int, *,
                    pretrain: bool, finetune: bool, masks: Dict[str, float],
                    net_sched: Dict, cls_sched: Optional[Dict],
                    bb_warmup: Optional[tuple] = None) -> Dict:
        """One epoch over ``loader`` (two-view batches). ``net_sched``:
        {"T", "eta_min", "step" (advanced here)}; ``cls_sched``: {"T0",
        "eta_min"} or None; ``bb_warmup``: (freeze_epochs, warmup_epochs),
        a linear LR ramp on the "backbone" group after the unfreeze."""
        args = self.args
        weights = ((epoch / nr_epochs, 5.0, 0.0) if pretrain
                   else (5.0, 2.0, 2.0))
        print("Align weight:", weights[0], ", U_tanh weight:", weights[1],
              "Class weight:", weights[2], flush=True)
        print("Pretrain?", pretrain, "Finetune?", finetune, flush=True)
        set_trainable(self.model, self.labels, masks)
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        cfg = getattr(loader, "device_augment_cfg", None)
        augment = (make_device_twoview_augment(cfg) if cfg is not None
                   else None)
        iters = len(loader)
        totals = {k: torch.zeros((), device=self.device) for k in _METRICS}
        lrs_net, lrs_class = [], []
        n = 0
        t0 = time.time()
        for i, host_batch in enumerate(loader):
            sched = self.sched(i, iters, epoch, pretrain=pretrain,
                               finetune=finetune, net_sched=net_sched,
                               cls_sched=cls_sched, bb_warmup=bb_warmup,
                               weights=weights)
            if augment is not None:
                xs, ys = host_batch  # uint8 single views
                v1, v2 = augment(self.aug_generator,
                                 torch.as_tensor(xs, device=self.device),
                                 BatchShard(self.mesh)
                                 if self.mesh.distributed else None)
            else:
                xs1, xs2, ys = host_batch
                v1, v2 = self.to_device(xs1), self.to_device(xs2)
            batch = (v1, v2, self.to_device(ys, torch.int64))
            metrics = train_step(
                self.model, self.optimizer, batch, sched,
                is_count_pipnet=self.is_count,
                enforce_weight_sparsity=getattr(
                    args, "enforce_weight_sparsity", True),
                tanh_loss_coeff=getattr(args, "tanh_loss_coeff", 1.0),
                generator=self.generator, dtype=self.dtype, mesh=self.mesh)
            for k in _METRICS:
                totals[k] += metrics[k]
            if not finetune:
                net_sched["step"] += 1
                lrs_net.append(sched["lr"]["backbone"])
            else:
                lrs_net.append(0.0)
            if not pretrain:
                lrs_class.append(sched["lr"]["cls_weight"])
            n += 1
        n = max(n, 1)
        mean = {k: float(v) / n for k, v in totals.items()}
        dt = time.time() - t0
        info = {
            "loss": mean["loss"], "train_accuracy": mean["acc"],
            "align_loss_raw": mean["align"], "tanh_loss_raw": mean["tanh"],
            "class_loss_raw": mean["class"],
            "align_loss_weighted": mean["align_weighted"],
            "tanh_loss_weighted": mean["tanh_weighted"],
            "class_loss_weighted": mean["class_weighted"],
            "lrs_net": lrs_net, "lrs_class": lrs_class,
            "epoch_time_s": dt, "steps_per_s": n / dt if dt > 0 else 0.0,
        }
        print(f"\nEpoch {epoch} loss breakdown:")
        print(f"  Alignment loss: {info['align_loss_raw']:.4f} (raw), "
              f"{info['align_loss_weighted']:.4f} (weighted)")
        print(f"  Tanh loss: {info['tanh_loss_raw']:.4f} (raw), "
              f"{info['tanh_loss_weighted']:.4f} (weighted)")
        print(f"  Classification loss: {info['class_loss_raw']:.4f} (raw), "
              f"{info['class_loss_weighted']:.4f} (weighted)")
        print(f"  Epoch time: {dt:.1f}s ({info['steps_per_s']:.2f} steps/s)",
              flush=True)
        return info

    def update_temperature(self, new_tau: float):
        self.tau = float(new_tau)

    def anneal_tau(self, epoch: int):
        """Pretraining annealing 1.0 -> 0.1 with a 25 % stabilisation tail
        (reference main.py:264-290)."""
        total = self.args.epochs_pretrain
        annealing = max(total - int(total * 0.25), 1)
        tau = 1.0 - 0.9 * (epoch / annealing) if epoch <= annealing else 0.1
        self.update_temperature(tau)
        print(f"Updated Gumbel-Softmax temperature to {tau:.3f} "
              f"(Pretraining phase)", flush=True)

    @torch.no_grad()
    def zero_small_weights(self):
        """Periodic weight zeroing (reference main.py:395-403)."""
        w = self.model.classification.weight
        w.sub_(0.001).clamp_(min=0.0)
        print(f"Classifier weights: {int(torch.count_nonzero(w))} non-zero "
              f"entries after zeroing", flush=True)


def _plot_lrs(values, path):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.clf()
        plt.plot(values)
        plt.savefig(path)
        plt.close()
    except Exception as e:  # pragma: no cover
        print(f"lr plot skipped: {e}")


def _print_scoring_sheet(trainer, classes):
    """The learned scoring sheet: relevant prototypes per class."""
    cpw = class_prototype_weights(trainer.model).cpu().numpy()
    for c in range(trainer.num_classes):
        relevant = [(p, float(cpw[c, p])) for p in range(cpw.shape[1])
                    if cpw[c, p] > 1e-3]
        relevant.sort(key=lambda t: -t[1])
        name = classes[c] if classes and c < len(classes) else c
        print(f"Class {c} ({name}): has {len(relevant)} relevant "
              f"prototypes: {relevant}", flush=True)


def _visualize(trainer, projectloader, num_classes, folder, args, what,
               **kw):
    """vizualize_network into ``<log_dir>/<folder>``; a failure is printed
    and the run carries on, as in the JAX trainer. Its wall time is printed:
    in a world, the other ranks wait that long at their next collective."""
    t0 = time.time()
    try:
        from ..interpret.vis_pipnet import vizualize_network
        vizualize_network(trainer, projectloader, num_classes, folder, args,
                          **kw)
    except Exception as e:
        print(f"({what} skipped: {e})", flush=True)
    print(f"  {what} took {time.time() - t0:.1f}s", flush=True)


def _interpret(trainer, projectloader, classes, args, log):
    """``--interpret``: the interpretability suite on the finished model
    (JAX trainer, its train/trainer.py:780-830): prediction explanations
    of the recipe's test images, activation histograms, IDG attributions
    of one projection image a class through the live model, and CUB part
    purity when the part annotations are on disk. Each part that fails
    prints why and the run carries on."""
    num_classes = len(classes)
    try:
        from ..data.registry import DATASET_RECIPES
        from ..interpret.visualize_prediction import vis_pred
        _, (_tr, _pr, test_d, *_rest) = DATASET_RECIPES[args.dataset]
        if test_d is not None and os.path.isdir(test_d):
            vis_pred(trainer, test_d, classes, args)
    except Exception as e:
        print(f"(prediction explanations skipped: {e})", flush=True)
    try:
        from ..interpret.histograms import \
            plot_prototype_activations_by_class
        plot_prototype_activations_by_class(
            trainer, projectloader, num_classes,
            os.path.join(args.log_dir, "activation_histograms"), args,
            class_names=classes)
    except Exception as e:
        print(f"(activation histograms skipped: {e})", flush=True)
    try:
        from ..interpret.interpret_idg import interpret
        interpret({"run_dir": args.log_dir,
                   "images_per_class": getattr(
                       args, "interpret_images_per_class", 1),
                   "method": getattr(args, "interpret_method", "IDG")},
                  model=trainer.model, args=args)
    except Exception as e:
        print(f"(saliency attribution skipped: {e})", flush=True)
    try:
        cub_root = "data/CUB_200_2011"
        parts_loc = os.path.join(cub_root, "parts", "part_locs.txt")
        parts_name = os.path.join(cub_root, "parts", "parts.txt")
        imgs_id = os.path.join(cub_root, "images.txt")
        if (str(getattr(args, "dataset", "")).startswith("CUB")
                and all(os.path.exists(p) for p in
                        (parts_loc, parts_name, imgs_id))):
            from ..interpret.eval_cub_csv import (
                eval_prototypes_cub_parts_csv, get_topk_cub)
            csvfile = get_topk_cub(trainer, projectloader, 10, "best", args)
            eval_prototypes_cub_parts_csv(csvfile, parts_loc, parts_name,
                                          imgs_id, "best", args, log)
    except Exception as e:
        print(f"(CUB part purity skipped: {e})", flush=True)


def restore_initial_state(trainer, ckpt, args):
    """Resume, shared backbone or pretrained discovery (reference
    main.py:122-205), from the port's files or the JAX package's; resume
    first, so an interrupted run continues where it stopped. Sets
    ``args.epochs_pretrain`` to 0 when something was loaded. Returns
    (start_epoch, resumed)."""
    start_epoch, resumed = 1, False
    if getattr(args, "resume_training", False):
        res = ckpt.load_trained_checkpoint()
        if res is not None:
            state, meta = res
            trainer.model.load_state_dict(state["model"])
            if state.get("optimizer"):
                trainer.optimizer.load_state_dict(state["optimizer"])
            elif state.get("adamw_by_name"):  # a JAX package checkpoint
                load_adamw_by_name(trainer.optimizer, trainer.model,
                                   state["adamw_by_name"])
            args.epochs_pretrain = 0
            if meta.get("epoch") not in (None, "last"):
                start_epoch = int(meta["epoch"]) + 1
            if meta.get("tau") is not None:
                trainer.update_temperature(meta["tau"])
            if state.get("rng"):
                trainer.set_rng_state(state["rng"])
            resumed = True
            print(f"Resuming training from epoch {start_epoch}", flush=True)
    shared_loaded = False
    if not resumed and getattr(args, "shared_pretrained_dir", ""):
        cand = find_shared_backbone(args.shared_pretrained_dir)
        if cand and load_backbone_only(cand, trainer.model)["success"]:
            shared_loaded = True
            args.epochs_pretrain = 0
            print("Successfully loaded shared pretrained backbone",
                  flush=True)
    if not shared_loaded and not resumed:
        res = ckpt.load_pretrained_checkpoint()
        if res is not None:
            graft_pretrained(trainer.model, res[0]["model"])
            args.epochs_pretrain = 0
            print("Loaded pretrained checkpoint from standard location",
                  flush=True)
    trainer.replicate()
    return start_epoch, resumed


def _log_epoch(log, ckpt, trainer, epoch, info, eval_info, lrs_net,
               lrs_class, args):
    """A main epoch's files: the CSV row, the checkpoints, the lr plots."""
    log.log_values(
        "log_epoch_overview", epoch, eval_info["top1_accuracy"],
        eval_info["local_size_for_true_class"],
        eval_info["local_size_for_all_classes"],
        eval_info["prototypes_per_class"], eval_info["almost_nonzeros"],
        eval_info["num non-zero prototypes"], info["train_accuracy"],
        info["loss"], info["align_loss_raw"], info["tanh_loss_raw"],
        info["class_loss_raw"], info["align_loss_weighted"],
        info["tanh_loss_weighted"], info["class_loss_weighted"])
    model_state = trainer.model.state_dict()
    opt_state = trainer.optimizer.state_dict()
    ckpt.save_trained_checkpoint(model_state, opt_state, epoch,
                                 tau=trainer.tau, rng=trainer.rng_state())
    ckpt.save_best_checkpoint(model_state, opt_state, epoch,
                              eval_info["top1_accuracy"])
    _plot_lrs(lrs_net, os.path.join(args.log_dir, "lr_net.png"))
    _plot_lrs(lrs_class, os.path.join(args.log_dir, "lr_class.png"))


def _load_best(ckpt, trainer):
    """``net_best``, read by every rank once rank 0 has written it (the
    JAX trainer's sync and visibility check): a rank that does not see
    rank 0's file raises, since its --log_dir is not shared."""
    distributed.barrier()
    best = ckpt.load_best_checkpoint()
    if trainer.mesh.distributed:
        have = bool(distributed.broadcast_one_to_all(best is not None))
        if have != (best is not None):
            raise RuntimeError(
                "net_best checkpoint visible on process 0 but not on "
                f"process {trainer.mesh.rank}: --log_dir must be on a "
                "filesystem shared across the ranks")
    return best


def run_pipnet(args, loaders=None):
    """Full training run (reference main.py:42-496). ``loaders``: the
    8-tuple of ``data.get_dataloaders`` (seven loaders and the class
    names), built from ``args.dataset`` when None."""
    check_ported(args)
    if loaders is None:
        from ..data.registry import validate_dataset_paths
        validate_dataset_paths(args)
    log = Log(args.log_dir)
    print("Log dir:", args.log_dir, flush=True)
    # a data-parallel world runs this on every rank; only rank 0 writes
    # files, so N ranks never write one path at once
    is_main = distributed.process_index() == 0
    if is_main:
        save_args(args, log.metadata_dir)
    if loaders is None:
        from ..data.registry import get_dataloaders
        loaders = get_dataloaders(args)
    (trainloader, trainloader_pretraining, _, _, projectloader, testloader,
     _, classes) = loaders
    num_classes = len(classes)

    ckpt = CheckpointManager(args)
    trainer = Trainer(args, num_classes, classes=classes)
    trainer.probe_wshape(trainloader)
    # after the probe's draws, so that a resumed run's streams are the
    # saved ones
    start_epoch, resumed = restore_initial_state(trainer, ckpt, args)
    if is_main:
        log.create_log("log_epoch_overview", "epoch", *LOG_COLUMNS,
                       append=resumed)

    # ---------------- PHASE 1: prototype pretraining ----------------------
    net_sched = {"T": len(trainloader_pretraining) * args.epochs_pretrain,
                 "eta_min": args.lr_block / 100.0, "step": 0}
    lrs_pretrain = []
    for epoch in range(1, args.epochs_pretrain + 1):
        print("\nPretrain Epoch", epoch, "with batch size",
              getattr(trainloader_pretraining, "batch_size", "?"),
              flush=True)
        info = trainer.train_epoch(
            trainloader_pretraining, epoch, args.epochs_pretrain,
            pretrain=True, finetune=False, masks=trainer.pretrain_masks(),
            net_sched=net_sched, cls_sched=None)
        if trainer.is_count and trainer.use_gumbel:
            trainer.anneal_tau(epoch)
        lrs_pretrain += info["lrs_net"]
        if not is_main:
            continue
        _plot_lrs(lrs_pretrain, os.path.join(args.log_dir,
                                             "lr_pretrain_net.png"))
        log.log_values(
            "log_epoch_overview", epoch, "n.a.", "n.a.", "n.a.", "n.a.",
            "n.a.", "n.a.", "n.a.", info["loss"], info["align_loss_raw"],
            info["tanh_loss_raw"], "n.a.", info["align_loss_weighted"],
            info["tanh_loss_weighted"], "n.a.")
    if is_main:
        if args.epochs_pretrain > 0 and not resumed:
            ckpt.save_pretrained_checkpoint(trainer.model.state_dict())
        _visualize(trainer, projectloader, num_classes,
                   "visualised_pretrained_prototypes_topk", args,
                   "pretrain prototype visualization", k=10,
                   are_pretraining_prototypes=True, plot_histograms=False,
                   visualize_prototype_maps=False,
                   plot_topk=getattr(args, "viz_topk", True))

    # ---------------- PHASE 2: classification training --------------------
    if not resumed:
        trainer.reinit_optimizers()
    iters = len(trainloader)
    done_epochs = max(0, start_epoch - 1 - args.epochs_finetune)
    net_sched = {"T": iters * args.epochs, "eta_min": args.lr_net / 100.0,
                 "step": done_epochs * iters}
    cls_sched = {"T0": 5 if args.epochs <= 30 else 10, "eta_min": 0.001}
    epochs_to_finetune = args.epochs_finetune
    freeze_epochs = args.freeze_epochs + epochs_to_finetune  # main.py:326
    profile_dir = getattr(args, "profile_dir", "")
    # --max_epochs_per_process: stop after this many epochs (pretraining
    # counts against the first process) with checkpoints/CHUNK_CONTINUE
    # beside the resumable net_trained_last; scripts/train_chunked.py
    # resumes until the finished run removes the marker.
    chunk_budget = int(getattr(args, "max_epochs_per_process", 0) or 0)
    chunk_marker = os.path.join(args.log_dir, "checkpoints",
                                "CHUNK_CONTINUE")
    epochs_this_process = args.epochs_pretrain
    lrs_net, lrs_class = [], []
    for epoch in range(start_epoch, args.epochs + 1):
        masks, finetune = trainer.main_masks(epoch, epochs_to_finetune,
                                             freeze_epochs)
        print("\n Epoch", epoch, "finetune:", finetune, flush=True)
        if (getattr(args, "enforce_weight_sparsity", True)
                and (epoch == args.epochs or epoch % 30 == 0)
                and args.epochs > 1):
            trainer.zero_small_weights()
        prof = None
        if profile_dir and epoch == start_epoch and is_main:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if trainer.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        info = trainer.train_epoch(
            trainloader, epoch, args.epochs, pretrain=False,
            finetune=finetune, masks=masks, net_sched=net_sched,
            cls_sched=cls_sched,
            bb_warmup=(freeze_epochs,
                       int(getattr(args, "unfreeze_warmup_epochs", 0))))
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  "train_epoch.json"))
            print(f"Profiler trace written to {profile_dir}", flush=True)
        lrs_net += info["lrs_net"]
        lrs_class += info["lrs_class"]

        eval_info = evaluate(
            trainer.model, testloader, epoch, num_classes=num_classes,
            enforce_weight_sparsity=getattr(args, "enforce_weight_sparsity",
                                            True),
            generator=trainer.eval_generator, tau=trainer.tau,
            dtype=trainer.dtype)
        if is_main:
            _log_epoch(log, ckpt, trainer, epoch, info, eval_info, lrs_net,
                       lrs_class, args)
        epochs_this_process += 1
        if (chunk_budget and epochs_this_process >= chunk_budget
                and epoch < args.epochs):
            if is_main:
                with open(chunk_marker, "w") as f:
                    f.write(str(epoch))
            print(f"\nChunk budget of {chunk_budget} epochs reached at "
                  f"epoch {epoch}/{args.epochs}; resume with "
                  "--resume_training to continue.", flush=True)
            return trainer

    if is_main and os.path.exists(chunk_marker):
        os.remove(chunk_marker)
    if args.epochs > 1 and is_main:
        # keep the final epoch number, so --resume_training on a finished
        # run extends it instead of restarting
        ckpt.save_trained_checkpoint(trainer.model.state_dict(),
                                     trainer.optimizer.state_dict(),
                                     args.epochs, tau=trainer.tau,
                                     rng=trainer.rng_state())
    print("\nLoading best model for prototype visualization...", flush=True)
    best = _load_best(ckpt, trainer)
    if best is not None:
        state, meta = best
        trainer.model.load_state_dict(state["model"])
        trainer.replicate()
        print(f"Loaded best model from epoch {meta.get('epoch')} with "
              f"accuracy {meta.get('accuracy', 0):.4f}", flush=True)
    if best is not None and is_main:
        _visualize(trainer, projectloader, num_classes,
                   f"visualised_prototypes_topk_best_model_epoch"
                   f"{meta.get('epoch')}", args, "prototype visualization",
                   plot_histograms=getattr(args, "viz_histograms", False),
                   visualize_prototype_maps=getattr(
                       args, "viz_prototype_maps", True),
                   plot_topk=getattr(args, "viz_topk", True),
                   are_pretraining_prototypes=False)
    elif best is None:
        print("Failed to load best model for prototype visualization",
              flush=True)
    _print_scoring_sheet(trainer, classes)
    if getattr(args, "interpret", False) and is_main:
        _interpret(trainer, projectloader, classes, args, log)
    print("Done!", flush=True)
    return trainer
