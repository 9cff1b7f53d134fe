"""The port's command line: the JAX package's flags and defaults
(count_pipnet_tpu/config.py), its YAML overlay and run-dir persistence.

* ``--config <yaml>`` sets parser *defaults*, so explicit flags still win;
  unknown YAML keys print a warning (PyYAML is imported only then);
* ``save_args`` writes ``args.txt`` (quoted strings) and a pickle.

A flag whose path the port does not carry would raise
``NotImplementedError`` when training starts (train/trainer.py:
check_ported), naming its ROADMAP Queue 1 item by its title; none is left.
``--disable_cuda`` selects the CPU; without it the CLI needs a CUDA
device.
"""

import argparse
import os
import pickle

__all__ = ["build_parser", "get_args", "args_from_yaml", "save_args",
           "DEFAULTS"]


def _bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "Train a Count-PIPNet (PyTorch port, NVIDIA H100)")
    add = p.add_argument
    add("--config", type=str, default="", help="Path to YAML config file")
    add("--dataset", type=str, default="CUB-200-2011")
    add("--validation_size", type=float, default=0.0,
        help="train/val split fraction when no test dir exists")
    add("--net", type=str, default="convnext_tiny_26",
        help="backbone: convnext_tiny_26/13, resnet18/34/50/50_inat/101/152")
    add("--batch_size", type=int, default=64)
    add("--batch_size_pretrain", type=int, default=128)
    add("--epochs", type=int, default=60)
    add("--epochs_pretrain", type=int, default=10)
    add("--epochs_finetune", type=int, default=20)
    add("--optimizer", type=str, default="Adam")
    add("--lr", type=float, default=0.05,
        help="classifier learning rate")
    add("--tanh_loss_coeff", type=float, default=1.0)
    add("--lr_block", type=float, default=0.0005)
    add("--lr_net", type=float, default=0.0005)
    add("--weight_decay", type=float, default=0.0)
    add("--disable_cuda", action="store_true",
        help="run on the CPU (the kernels' plain versions); without it a "
             "CUDA device is required")
    add("--log_dir", type=str, default="./runs/run_pipnet")
    add("--num_features", type=int, default=0,
        help="number of prototypes; 0 = backbone channel count")
    add("--image_size", type=int, default=224)
    add("--state_dict_dir_net", type=str, default="",
        help="directory containing a pretrained checkpoint")
    add("--freeze_epochs", type=int, default=10)
    add("--dir_for_saving_images", type=str, default="visualization_results")
    add("--disable_pretrained", action="store_true")
    add("--weighted_loss", action="store_true")
    add("--seed", type=int, default=1)
    add("--gpu_ids", type=str, default="",
        help="accepted for CLI parity and inert: the port runs on one "
             "device (cuda:0)")
    add("--num_workers", type=int, default=8)
    add("--bias", action="store_true")
    add("--extra_test_image_folder", type=str, default="./experiments")
    add("--pretrained_checkpoints_dir", type=str, default="")
    add("--shared_pretrained_dir", type=str, default="")
    add("--resume_training", action="store_true")
    # Count-PIPNet flags
    add("--model", type=str, default="pipnet",
        help='"count_pipnet" for Count-PIPNet; any other value trains the '
             'original PIP-Net (max-pooled softmax head)')
    add("--use_mid_layers", action="store_true")
    add("--num_stages", type=int, default=3)
    add("--max_count", type=int, default=3)
    add("--use_ste", type=_bool, choices=[True, False], default=False)
    add("--activation", type=str, default="gumbel_softmax",
        help="softmax or gumbel_softmax")
    add("--intermediate_layer", type=str, default="onehot",
        help="onehot | linear | linear_full | bilinear | identity")
    add("--train_intermediate", type=_bool, choices=[True, False],
        default=True)
    add("--enforce_weight_sparsity", type=_bool, choices=[True, False],
        default=True)
    add("--positive_grad_strategy", type=str, default=None,
        choices=[None, "current_grad", "max_grad"])
    add("--backward_clamp_strategy", type=str, default="Identity",
        choices=["Identity", "Gated"])
    # additions of the JAX package
    add("--unfreeze_warmup_epochs", type=int, default=0,
        help="ramp the lower-backbone LR linearly from 0 over this many "
             "epochs after the freeze_epochs unfreeze boundary (0 = the "
             "reference's instant unfreeze). Stabilization lever for "
             "random-init flagship runs: the full unfreeze collapses "
             "training when the early stages are not ImageNet-pretrained "
             "(analysis/flagship_200_canon/)")
    add("--pipeline_depth", type=int, default=2,
        help="accepted and inert: the port's train step never waits on "
             "its metrics (they are read once per epoch), so the host "
             "runs ahead of the device as far as CUDA's queue allows")
    add("--device_augment", action="store_true",
        help="two-view augmentation on the card (synthetic shapes / MNIST "
             "recipes): the host loader ships one uint8 image per sample, "
             "and color jitter, crop, gaussian noise and normalization of "
             "both views run as torch ops on the device "
             "(data/device_augment.py)")
    add("--device_geometric", action="store_true",
        help="with --device_augment on the shapes recipes: also the shared "
             "transform1 (Resize + RandomRotation + RandomResizedCrop) on "
             "the card, as one bilinear resample of the raw image")
    add("--cache_decoded", action="store_true",
        help="memoize decoded training/eval images in host RAM (skips "
             "PNG/JPEG decode after the first epoch; ~1.5 GB at 10k "
             "224^2 images — for the synthetic datasets, not CUB-scale "
             "native-resolution photos)")
    add("--decode_cache_dir", type=str, default="",
        help="with --cache_decoded: persist the decoded images as one "
             "fingerprinted memory-mapped .npy per image folder in this "
             "directory. Resumed and repeat runs skip the decode pass "
             "entirely, and the "
             "read-only mmap replaces the per-process RAM copy. "
             "Uniform image sizes required (synthetic datasets); "
             "falls back to the RAM cache otherwise")
    add("--fused_whole_blocks", action="store_true",
        help="whole ConvNeXt blocks in training through the hand-written "
             "block kernel (kernel A: depthwise conv, LayerNorm, MLP, "
             "layer scale and residual, bf16 GEMMs) as the forward; the "
             "backward recomputes the block in PyTorch ops. tanh-approx "
             "GELU; supersedes --fused_blocks and --fused_dwconv. Same "
             "parameters as the default route; checkpoints interchange")
    add("--fused_blocks", action="store_true",
        help="run the ConvNeXt block bodies after the depthwise conv "
             "through the hand-written kernels K5 (forward) and K6 "
             "(backward), tanh-approx GELU. Same parameters as the "
             "default route; checkpoints interchange")
    add("--max_epochs_per_process", type=int, default=0,
        help="exit with a resumable checkpoint after this many main "
             "epochs in one process (0 = unlimited); continue with "
             "--resume_training")
    add("--no_phase_dce", action="store_true",
        help="accepted and inert: frozen parameter groups have "
             "requires_grad off, so autograd never computes their "
             "backward in any phase")
    add("--fused_dwconv", action="store_true",
        help="the depthwise 7x7 conv forward through the hand-written "
             "kernel K7, its gradients through PyTorch's conv backward; "
             "composes with --fused_blocks. Same parameters as the "
             "default route; checkpoints interchange")
    add("--viz_topk", type=_bool, choices=[True, False], default=True,
        help="save per-prototype top-k patch PNGs during the best-model "
             "visualization (reference vis_pipnet plot_topk)")
    add("--viz_prototype_maps", type=_bool, choices=[True, False],
        default=True,
        help="render rich prototype feature-map artifacts (original + "
             "rect, side-by-side heatmap, masked overlay, debug txt) for "
             "the best model (reference util/vis_pipnet.py:354-486, "
             ":888-1032)")
    add("--viz_histograms", type=_bool, choices=[True, False],
        default=False,
        help="plot per-class prototype activation histograms during the "
             "best-model visualization")
    add("--interpret", action="store_true",
        help="after training, run the interpretability suite on the "
             "finished run: prediction explanations (vis_pred) and "
             "activation histograms; saliency attribution stays available "
             "via count_pipnet_tpu_torch.interpret.interpret_idg")
    add("--dtype", type=str, default="bfloat16",
        choices=["bfloat16", "float32"],
        help="compute dtype: bfloat16 = torch.autocast over the forward "
             "with f32 parameters")
    add("--mesh_shape", type=int, default=-1,
        help="data-parallel device count: N > 1 runs N ranks (spawned "
             "by main.py, one a CUDA device or gloo CPU ranks with "
             "--disable_cuda; under torchrun -1 or the world size)")
    add("--profile_dir", type=str, default="",
        help="when set, write a torch.profiler trace of the first main "
             "epoch into this dir")
    return p


DEFAULTS = {a.dest: a.default for a in build_parser()._actions
            if a.dest != "help"}


def _apply_yaml_defaults(parser, config_path):
    import yaml
    with open(config_path) as f:
        config = yaml.safe_load(f) or {}
    known = {a.dest for a in parser._actions if a.dest != "help"}
    updates = {}
    for key, value in config.items():
        if key in known:
            updates[key] = value
        else:
            print(f"Warning: Config contains unknown parameter '{key}'")
    if updates:
        parser.set_defaults(**updates)
    return parser


def get_args(argv=None) -> argparse.Namespace:
    """Parse CLI args; a --config YAML file supplies defaults only
    (explicit CLI flags take precedence, reference util/args.py:194-220)."""
    parser = build_parser()
    known, _ = parser.parse_known_args(argv)
    if known.config and os.path.exists(known.config):
        print("Using the config parameters as default. Command-line "
              "arguments still take precedence.")
        _apply_yaml_defaults(parser, known.config)
    args = parser.parse_args(argv)
    if len(args.log_dir.split("/")) > 2 and not os.path.exists(args.log_dir):
        os.makedirs(args.log_dir, exist_ok=True)
    return args


def args_from_yaml(config_path, **overrides) -> argparse.Namespace:
    """Build a namespace straight from a YAML file plus overrides — the
    sweep-runner path (reference run_multiple_configs.py:121-179)."""
    parser = build_parser()
    _apply_yaml_defaults(parser, config_path)
    args = parser.parse_args([])
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def save_args(args, directory_path) -> None:
    """Persist args as args.txt (readable) + args.pickle (reusable).
    Reference: util/args.py:228-248."""
    os.makedirs(directory_path, exist_ok=True)
    with open(os.path.join(directory_path, "args.txt"), "w") as f:
        for arg in vars(args):
            val = getattr(args, arg)
            if isinstance(val, str):
                val = f"'{val}'"
            f.write(f"{arg}: {val}\n")
    with open(os.path.join(directory_path, "args.pickle"), "wb") as f:
        pickle.dump(args, f)
