"""Pretrained-checkpoint validation kit for the port's backbones.

The port's copy of the JAX package's scripts/validate_pretrained.py. The
port loads a torchvision ``convnext_tiny`` state dict by name into
models/convnext.py's ``ConvNeXtFeatures`` (its modules carry torchvision's
names; stages past ``--num_stages`` are truncated) and a torchvision or
BBN iNaturalist ResNet one through models/convert.py's
``from_torch_resnet``. No real checkpoint has passed through that path
yet; this script checks one in a single invocation:

    python -m count_pipnet_tpu_torch.scripts.validate_pretrained \
        --checkpoint convnext_tiny-983f1562.pth --arch convnext_tiny \
        [--num_stages 7] [--save-goldens out.npz] [--disable_cuda]

    python -m count_pipnet_tpu_torch.scripts.validate_pretrained \
        --checkpoint BBN.iNaturalist2017.res50.pth --arch resnet50 --inat

In order:
  1. COVERAGE: every source tensor is loaded or on the skip lists (fc.*,
     classifier.*, head.*, num_batches_tracked, truncated stages, and
     with --inat everything outside module.backbone.* and rb_block), and
     every parameter and buffer of a fresh module is filled, with exact
     shapes;
  2. SENTINEL ROUND TRIP through the loading path: the i-th loaded source
     tensor filled with the value i (skipped ones with -1), loaded into a
     fresh module, read back from its state dict: every value must be a
     loaded tensor's sentinel and every sentinel must surface;
  3. the module's forward on a seeded input, and (ConvNeXt) an
     INDEPENDENT forward computed with torch.nn.functional straight from
     the torchvision-named tensors; their agreement catches the same-shape
     permutations that no accounting check can see;
  4. forward parity against the live reference feature extractor
     (``$REFERENCE_DIR/features/*_features.py``) where torchvision and
     the reference checkout are present, else the skip reason is printed;
     ``--save-goldens`` writes the input and features as an .npz with the
     JAX kit's keys, so that the two files can be diffed.

The forwards run on the CUDA card unless ``--disable_cuda`` is given, in
float32 with TF32 off.
"""

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import from_torch_resnet
from ..models.convnext import ConvNeXtFeatures
from ..models import resnet as R
from . import checked_device, no_tf32

SKIP_SUBSTRINGS = ("num_batches_tracked",)
SKIP_PREFIXES = ("fc.", "classifier.", "head.")
RESNETS = {"resnet18": R.resnet18_features, "resnet34": R.resnet34_features,
           "resnet50": R.resnet50_features, "resnet101": R.resnet101_features,
           "resnet152": R.resnet152_features}


def load_state_dict(path):
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        obj = torch.load(path, map_location="cpu")
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        raise SystemExit(f"checkpoint {path} is not a state dict "
                         f"(got {type(obj)})")
    return dict(obj)


def is_skipped(k, inat=False, extra_skip=None):
    """Whether source tensor ``k`` is left out on purpose."""
    return (any(s in k for s in SKIP_SUBSTRINGS)
            or any(k.startswith(p) for p in SKIP_PREFIXES)
            or (extra_skip is not None and extra_skip(k))
            or (inat and (not k.startswith("module.backbone.")
                          or "rb_block" in k)))


def truncated(num_stages):
    """The predicate of the feature stages past ``num_stages``."""
    kept = {0} | set(range(1, min(num_stages, 7) + 1))

    def past(k):
        parts = k.split(".")
        return (parts[0] == "features" and parts[1].isdigit()
                and int(parts[1]) not in kept)
    return past


def convert_convnext(sd, num_stages):
    """A torchvision convnext_tiny state dict -> ConvNeXtFeatures' (same
    names; the skipped and truncated tensors left out)."""
    past = truncated(num_stages)
    return {k: torch.from_numpy(_np(v)) for k, v in sd.items()
            if not is_skipped(k, extra_skip=past)}


def build_module(arch, num_stages=7):
    """A fresh module of ``arch`` (the load target), its tensors
    allocated and not initialised."""
    with torch.device("meta"):
        module = (ConvNeXtFeatures(num_stages=num_stages)
                  if arch == "convnext_tiny" else RESNETS[arch]())
    return module.to_empty(device="cpu")


def _np(v):
    return (v.detach().cpu().float().numpy() if torch.is_tensor(v)
            else np.asarray(v, np.float32))


def check_coverage(sd, converted, inat=False, extra_skip=None):
    """1:1 accounting of source tensors against loaded tensors."""
    src = {k: _np(v) for k, v in sd.items()
           if not is_skipped(k, inat, extra_skip)}
    n_src = sum(v.size for v in src.values())
    n_dst = sum(v.numel() for v in converted.values())
    print(f"  source tensors: {len(src)} ({n_src:,} params)")
    print(f"  converted tensors: {len(converted)} ({n_dst:,} params)")
    if n_src != n_dst:
        print(f"  !! element-count mismatch: {n_src - n_dst:+,} — "
              f"some source tensors were not mapped")
    return src, converted, n_src == n_dst


def check_shapes_vs_init(module, converted):
    """Every parameter and buffer of a fresh module filled, exact shapes."""
    ref = module.state_dict()
    missing = sorted(set(ref) - set(converted))
    extra = sorted(set(converted) - set(ref))
    bad = [(k, tuple(ref[k].shape), tuple(converted[k].shape))
           for k in sorted(set(ref) & set(converted))
           if ref[k].shape != converted[k].shape]
    for k in missing:
        print(f"  !! missing converted tensor: {k} {tuple(ref[k].shape)}")
    for k in extra:
        print(f"  !! unexpected converted tensor: {k} "
              f"{tuple(converted[k].shape)}")
    for k, a, b in bad:
        print(f"  !! shape mismatch {k}: init {a} vs converted {b}")
    ok = not (missing or extra or bad)
    print(f"  structural check vs fresh module: {'OK' if ok else 'FAILED'}")
    return ok


def check_sentinel_roundtrip(convert, sd, make_module, inat=False,
                             extra_skip=None):
    """Source-to-module accounting at the value level, through the
    loading path: ``convert`` of a state dict whose i-th loaded tensor
    holds the value i (skipped ones -1), loaded into ``make_module()``,
    read back. The loading path only renames and reshapes, so every value
    must be some loaded tensor's sentinel and every sentinel must surface.
    Catches dropped, duplicated or transformed tensors and skip-list
    leaks; not a permutation of same-shaped tensors (the independent
    forward is for that)."""
    sent, consumed = {}, {}
    idx = 0
    for k, v in sd.items():
        shape = tuple(v.shape)
        if is_skipped(k, inat, extra_skip):
            sent[k] = torch.full(shape, -1.0)
        else:
            idx += 1
            sent[k] = torch.full(shape, float(idx))
            consumed[k] = float(idx)
    module = make_module()
    try:
        module.load_state_dict(convert(sent), strict=True)
    except (RuntimeError, KeyError) as e:
        print(f"  !! the sentinel state dict does not load: "
              f"{str(e).splitlines()[0]}")
        print(f"  sentinel round-trip ({idx} sources): FAILED")
        return False
    expected = set(consumed.values())
    seen, ok = set(), True
    leaves = module.state_dict()
    for name, leaf in leaves.items():
        vals = set(torch.unique(leaf.float()).tolist())
        bad = vals - expected
        if bad:
            print(f"  !! tensor {name} holds values from no loaded source "
                  f"(or from a skipped one): {sorted(bad)[:4]}")
            ok = False
        seen |= vals & expected
    unseen = expected - seen
    if unseen:
        names = [k for k, i in consumed.items() if i in unseen]
        print(f"  !! {len(unseen)} loaded source tensors never reach "
              f"the module: {names[:4]}")
        ok = False
    print(f"  sentinel round-trip ({idx} sources -> {len(leaves)} "
          f"tensors): {'OK' if ok else 'FAILED'}")
    return ok


def forward_from_sd_convnext(sd, x, num_stages, stride_threshold=100,
                             device="cuda"):
    """Backbone features [B, H', W', C] computed straight from the
    torchvision-named tensors with torch.nn.functional, bypassing
    ConvNeXtFeatures: an independent implementation of the reference's
    stride-modified convnext_tiny (reference features/convnext_features.py:
    17-65; ``features.0`` stem, ``features.{odd}.{j}.block.*`` blocks,
    ``features.{even}.{0,1}`` downsample LayerNorm + conv; a stride-2 conv
    whose in_channels exceed ``stride_threshold`` runs at stride 1). On
    the card unless ``device`` is the CPU."""
    device = checked_device(device)

    def g(k):
        return torch.as_tensor(_np(sd[k]), device=device)

    def ln(h, pre, eps=1e-6):       # channels last
        m = h.mean(-1, keepdim=True)
        v = ((h - m) ** 2).mean(-1, keepdim=True)
        return (h - m) / torch.sqrt(v + eps) * g(f"{pre}.weight") \
            + g(f"{pre}.bias")

    def conv(h, pre, stride, groups=1, padding=0):   # NHWC in and out
        y = F.conv2d(h.permute(0, 3, 1, 2), g(f"{pre}.weight"),
                     g(f"{pre}.bias"), stride=stride, padding=padding,
                     groups=groups)
        return y.permute(0, 2, 3, 1)

    with no_tf32():
        h = conv(torch.as_tensor(np.asarray(x, np.float32), device=device),
                 "features.0.0", 4)
        h = ln(h, "features.0.1")
        stage_blocks = {1: 3, 3: 3, 5: 9, 7: 3}
        for i in range(1, min(num_stages, 7) + 1):
            if i % 2 == 1:
                for j in range(stage_blocks[i]):
                    pre = f"features.{i}.{j}.block"
                    y = conv(h, f"{pre}.0", 1, groups=h.shape[-1],
                             padding=3)
                    y = ln(y, f"{pre}.2")
                    y = y @ g(f"{pre}.3.weight").T + g(f"{pre}.3.bias")
                    y = F.gelu(y)
                    y = y @ g(f"{pre}.5.weight").T + g(f"{pre}.5.bias")
                    h = h + y * g(f"features.{i}.{j}.layer_scale").reshape(-1)
            else:
                stride = 1 if h.shape[-1] > stride_threshold else 2
                h = ln(h, f"features.{i}.0")
                h = conv(h, f"features.{i}.1", stride)
    return h.cpu().numpy()


def forward_ours(module, converted, x, device="cuda"):
    """The module's eval forward [B, H', W', C] with ``converted`` loaded,
    on the card unless ``device`` is the CPU."""
    device = checked_device(device)
    module.load_state_dict(converted, strict=True)
    module = module.to(device).eval()
    with torch.no_grad(), no_tf32():
        feats = module(torch.as_tensor(np.asarray(x, np.float32),
                                       device=device))
    return feats.float().cpu().numpy()


def try_torch_parity(arch, sd, x, feats_ours, inat):
    """Live parity against the reference feature extractor, if possible."""
    try:
        import torchvision  # noqa: F401
    except ImportError as e:
        print(f"  torch-parity SKIPPED: torchvision unavailable ({e}); "
              f"structural + round-trip checks above still hold. Re-run "
              f"on a torchvision-capable host to close forward parity.")
        return None
    ref_dir = os.environ.get("REFERENCE_DIR", "")
    rel = ("features/convnext_features.py" if arch.startswith("convnext")
           else "features/resnet_features.py")
    path = os.path.join(ref_dir, rel)
    if not ref_dir or not os.path.exists(path):
        print(f"  torch-parity SKIPPED: reference module missing ({path}; "
              "set REFERENCE_DIR to the reference checkout)")
        return None
    spec = importlib.util.spec_from_file_location("_ref_features", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_ref_features"] = mod
    spec.loader.exec_module(mod)
    if arch.startswith("convnext"):
        net = mod.convnext_tiny_26_features(pretrained=False)
        missing, unexpected = net.load_state_dict(
            {f"features.{k}" if not k.startswith("features") else k: v
             for k, v in sd.items()}, strict=False)
        print(f"  reference load: missing={len(missing)} "
              f"unexpected={len(unexpected)}")
    else:
        # the BBN iNat checkpoint goes to the reference's own extractor
        # (resnet_features.py:273-301), with from_torch_resnet's remap
        fn_name = f"{arch}_features_inat" if inat else f"{arch}_features"
        fn = getattr(mod, fn_name, None) or getattr(mod, f"{arch}_features")
        net = fn(pretrained=False)
        tsd = from_torch_resnet(sd, inat=inat)
        missing, unexpected = net.load_state_dict(tsd, strict=False)
        print(f"  reference load: missing={len(missing)} "
              f"unexpected={len(unexpected)}")
        if len(tsd) and len(unexpected) >= len(tsd):
            print("  !! no source tensor matched the reference net — "
                  "parity result would be meaningless")
            return False
    net.eval()
    with torch.no_grad():
        t = net(torch.tensor(np.moveaxis(x, -1, 1)))  # NHWC -> NCHW
    theirs = np.moveaxis(t.numpy(), 1, -1)
    diff = np.abs(theirs - feats_ours)
    rel = diff.max() / (np.abs(theirs).max() + 1e-9)
    print(f"  forward parity vs reference torch: max abs "
          f"{diff.max():.3e}, rel {rel:.3e} "
          f"({'OK' if rel < 1e-3 else 'DIVERGED'})")
    return rel < 1e-3


def validate(sd, arch, num_stages=7, inat=False, image_size=224,
             device="cuda", save_goldens=None, convert=None):
    """The four steps on state dict ``sd``; True when every check holds.
    The forwards run on the card unless ``device`` is the CPU.
    ``convert`` replaces the loading path's conversion (a test injects a
    miswired one)."""
    device = checked_device(device)
    if arch == "convnext_tiny":
        convert = convert or (lambda s: convert_convnext(s, num_stages))
        extra_skip = truncated(num_stages)
    else:
        convert = convert or (lambda s: from_torch_resnet(s, inat=inat))
        extra_skip = None

    def make_module():
        return build_module(arch, num_stages)

    converted = convert(sd)
    print("[2/4] conversion coverage + sentinel round-trip:")
    _, _, cov_ok = check_coverage(sd, converted, inat=inat,
                                  extra_skip=extra_skip)
    rt_ok = check_sentinel_roundtrip(convert, sd, make_module, inat=inat,
                                     extra_skip=extra_skip)
    module = make_module()
    ok = check_shapes_vs_init(module, converted)

    print("[3/4] forward on deterministic input:")
    shape = (1, image_size, image_size, 3)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    feats = (forward_ours(module, converted, x, device) if ok
             else np.full((1, 1, 1, 1), np.nan, np.float32))
    print(f"  features {feats.shape}: mean {feats.mean():+.4f} "
          f"std {feats.std():.4f} absmax {np.abs(feats).max():.4f} "
          f"finite={np.isfinite(feats).all()}")
    indep_ok = True
    if arch == "convnext_tiny" and ok:
        indep = forward_from_sd_convnext(sd, x, num_stages, device=device)
        d = np.abs(indep - feats)
        rel = d.max() / (np.abs(indep).max() + 1e-9)
        indep_ok = bool(rel < 1e-4)
        print(f"  independent direct-from-state-dict forward: max abs "
              f"{d.max():.3e}, rel {rel:.3e} "
              f"({'OK' if indep_ok else 'MISWIRED'})")

    print("[4/4] live torch forward parity:")
    parity = try_torch_parity(arch, sd, x, feats, inat) if ok else False

    if save_goldens:
        np.savez_compressed(save_goldens, input=x, features=feats,
                            arch=arch, num_stages=num_stages)
        print(f"goldens saved to {save_goldens}")
    return bool(cov_ok and rt_ok and ok and indep_ok
                and parity is not False and np.isfinite(feats).all())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--arch", required=True,
                    choices=["convnext_tiny", *RESNETS])
    ap.add_argument("--num_stages", type=int, default=7)
    ap.add_argument("--inat", action="store_true",
                    help="BBN iNaturalist checkpoint key remap")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--save-goldens", default=None)
    ap.add_argument("--disable_cuda", action="store_true",
                    help="run the forwards on the CPU")
    args = ap.parse_args(argv)
    if not args.disable_cuda and not torch.cuda.is_available():
        print("error: no CUDA device; pass --disable_cuda to run on the CPU",
              file=sys.stderr)
        return 2
    sd = load_state_dict(args.checkpoint)
    print(f"[1/4] loaded {args.checkpoint}: {len(sd)} tensors")
    ok = validate(sd, args.arch, args.num_stages, args.inat,
                  args.image_size,
                  device="cpu" if args.disable_cuda else "cuda",
                  save_goldens=args.save_goldens)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
