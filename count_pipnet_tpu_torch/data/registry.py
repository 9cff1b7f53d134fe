"""Dataset registry: name -> directories + augmentation recipe; the
7-loader contract.

The port's copy of count_pipnet_tpu/data/registry.py, with the
device-side augmentation (``--device_augment``, ``--device_geometric``:
data/device_augment.py). In a data-parallel world the two training
loaders are rank-local (each rank loads its slice of every global batch);
the eval and projection loaders stay global, and every rank evaluates the
whole set. A missing synthetic dataset is regenerated by the port's own
generators (data/ensure.py) before the paths are reported missing.

Reference: util/data.py:17-259. Datasets: CUB-200-2011, pets, partimagenet,
CARS, grayscale_example, geometric_shapes, geometric_shapes_gaussian_noise,
geometric_shapes_224_gaussian_noise, mnist_counting.

``get_dataloaders`` returns the same 7 loaders as the reference
(util/data.py:111-216): train (two-view), pretrain (bigger batch and, for
birds, a looser crop transform1p), train_normal, train_normal_augment,
projectloader (no shuffle, no aug), testloader, test_projectloader —
plus the class list.
"""

from pathlib import Path

from . import augment as A
from .datasets import (
    ImageFolder, TransformedDataset, TwoAugDataset, Subset, stratified_split,
)
from ..parallel.distributed import process_count, process_index
from .loader import DataLoader, make_weighted_sample_weights

__all__ = ["get_data", "get_dataloaders", "validate_dataset_paths",
           "device_augment_config", "DATASET_RECIPES"]


def _no_augment(img_size, grayscale=False):
    steps = [A.Resize(img_size)]
    if grayscale:
        steps.append(A.Grayscale3())
    steps += [A.ToArray(), A.Normalize()]
    return A.Compose(steps)


def _birds_recipe(img_size):
    """CUB: tight crop for main training, looser crop for pretraining
    (util/data.py:496-530)."""
    t1 = A.Compose([
        A.Resize(img_size + 8), A.TrivialAugmentWideNoColor(),
        A.RandomHorizontalFlip(),
        A.RandomResizedCrop(img_size + 4, scale=(0.95, 1.0)),
    ])
    t1p = A.Compose([
        A.Resize(img_size + 32), A.TrivialAugmentWideNoColor(),
        A.RandomHorizontalFlip(),
        A.RandomResizedCrop(img_size + 4, scale=(0.95, 1.0)),
    ])
    t2 = A.Compose([
        A.TrivialAugmentWideNoShape(), A.RandomCrop(img_size),
        A.ToArray(), A.Normalize(),
    ])
    return t1, t1p, t2


def _pets_recipe(img_size):
    t1 = A.Compose([
        A.Resize(img_size + 48), A.TrivialAugmentWideNoColor(),
        A.RandomHorizontalFlip(),
        A.RandomResizedCrop(img_size + 8, scale=(0.95, 1.0)),
    ])
    t2 = A.Compose([
        A.TrivialAugmentWideNoShape(), A.RandomCrop(img_size),
        A.ToArray(), A.Normalize(),
    ])
    return t1, None, t2


def _partimagenet_recipe(img_size):
    t1 = A.Compose([
        A.Resize(img_size + 48), A.TrivialAugmentWideNoColor(),
        A.RandomHorizontalFlip(),
        A.RandomResizedCrop(img_size + 8, scale=(0.95, 1.0)),
    ])
    t2 = A.Compose([
        A.TrivialAugmentWideNoShape(), A.RandomCrop(img_size),
        A.ToArray(), A.Normalize(),
    ])
    return t1, None, t2


def _cars_recipe(img_size):
    t1 = A.Compose([
        A.Resize(img_size + 32), A.TrivialAugmentWideNoColor(),
        A.RandomHorizontalFlip(),
        A.RandomResizedCrop(img_size + 4, scale=(0.95, 1.0)),
    ])
    t2 = A.Compose([
        A.TrivialAugmentWideNoShapeWithColor(), A.RandomCrop(img_size),
        A.ToArray(), A.Normalize(),
    ])
    return t1, None, t2


def _grayscale_recipe(img_size):
    # (the reference hardcodes RandomResizedCrop(224+8) here regardless of
    # img_size — util/data.py:585; fixed to track img_size)
    t1 = A.Compose([
        A.Resize(img_size + 32), A.TrivialAugmentWideNoColor(),
        A.RandomHorizontalFlip(),
        A.RandomResizedCrop(img_size + 8, scale=(0.95, 1.0)),
    ])
    t2 = A.Compose([
        A.TrivialAugmentWideNoShape(), A.RandomCrop(img_size),
        A.Grayscale3(), A.ToArray(), A.Normalize(),
    ])
    return t1, None, t2


def _shapes_recipe(img_size, gaussian_noise=False):
    """Synthetic shapes: light geometric aug, white rotation fill, minor
    color jitter, optional gaussian noise (util/data.py:292-410)."""
    t1 = A.Compose([
        A.Resize(img_size + 32),
        A.RandomRotation(10, fill=255),
        A.RandomResizedCrop(img_size + 8, scale=(0.95, 1.0)),
    ])
    steps2 = [
        A.ColorJitter(brightness=0.1, contrast=0.1),
        A.RandomCrop(img_size), A.ToArray(),
    ]
    if gaussian_noise:
        steps2.append(A.GaussianNoise(mean=0.0, std=0.1, p=0.5))
    steps2.append(A.Normalize())
    return t1, None, A.Compose(steps2)


def _mnist_recipe(img_size):
    t1 = A.Compose([
        A.Resize(img_size + 24),
        A.RandomAffine(10, translate=(0.1, 0.1), scale=(0.9, 1.1), fill=255),
        A.RandomResizedCrop(img_size + 8, scale=(0.95, 1.0)),
    ])
    t2 = A.Compose([
        A.ColorJitter(brightness=0.1, contrast=0.1),
        A.RandomCrop(img_size), A.ToArray(), A.Normalize(),
    ])
    return t1, None, t2


# name -> (recipe_fn(img_size) -> (t1, t1p, t2), dir spec)
# dir spec: (train, project, test, pretrain_train_dir, test_projection_dir,
#            grayscale)
DATASET_RECIPES = {
    "CUB-200-2011": (_birds_recipe, (
        "data/CUB_200_2011/dataset/train_crop",
        "data/CUB_200_2011/dataset/train",
        "data/CUB_200_2011/dataset/test_crop",
        "data/CUB_200_2011/dataset/train",
        "data/CUB_200_2011/dataset/test_full", False)),
    "pets": (_pets_recipe, (
        "data/PETS/dataset/train", "data/PETS/dataset/train",
        "data/PETS/dataset/test", None, None, False)),
    "partimagenet": (_partimagenet_recipe, (
        "data/partimagenet/dataset/all", "data/partimagenet/dataset/all",
        None, None, None, False)),
    "CARS": (_cars_recipe, (
        "data/cars/dataset/train", "data/cars/dataset/train",
        "data/cars/dataset/test", None, None, False)),
    "grayscale_example": (_grayscale_recipe, (
        "data/train", "data/train", "data/test", None, None, True)),
    "geometric_shapes": (lambda s: _shapes_recipe(s, False), (
        "data/geometric_shapes/dataset/train",
        "data/geometric_shapes/dataset/train",
        "data/geometric_shapes/dataset/test", None, None, False)),
    "shapes_200": (lambda s: _shapes_recipe(s, True), (
        "data/shapes_200/dataset/train",
        "data/shapes_200/dataset/train",
        "data/shapes_200/dataset/test", None, None, False)),
    # 4x-data variant of the flagship dataset (200 train imgs/class vs
    # 50): the free data-scale lever for the flagship accuracy ceiling —
    # the generator is deterministic, so scale costs only generation
    # time (VERDICT r4 item 2). Same recipe, disjoint directory.
    "shapes_200_x4": (lambda s: _shapes_recipe(s, True), (
        "data/shapes_200_x4/dataset/train",
        "data/shapes_200_x4/dataset/train",
        "data/shapes_200_x4/dataset/test", None, None, False)),
    "geometric_shapes_gaussian_noise": (lambda s: _shapes_recipe(s, True), (
        "data/geometric_shapes_no_noise/dataset/train",
        "data/geometric_shapes_no_noise/dataset/train",
        "data/geometric_shapes_no_noise/dataset/test", None,
        "data/geometric_shapes_no_noise_test/dataset/train", False)),
    "geometric_shapes_224_gaussian_noise": (
        lambda s: _shapes_recipe(s, True), (
            "data/geometric_shapes_224_no_noise/dataset/train",
            "data/geometric_shapes_224_no_noise/dataset/train",
            "data/geometric_shapes_224_no_noise/dataset/test", None, None,
            False)),
    "mnist_counting": (_mnist_recipe, (
        "data/mnist_counting/dataset/train",
        "data/mnist_counting/dataset/train",
        "data/mnist_counting/dataset/test", None, None, False)),
}


def validate_dataset_paths(args, basepath="./"):
    """Raise early, with the generator hint, if the named dataset's
    directories are missing. A synthetic dataset is regenerated in place
    first (data/ensure.py)."""
    if args.dataset not in DATASET_RECIPES:
        raise ValueError(
            f'Could not load data set, data set "{args.dataset}" not found!')
    _, dirs = DATASET_RECIPES[args.dataset]
    base = Path(basepath)

    def _missing():
        return sorted({str(base / d) for d in dirs
                       if isinstance(d, str) and not (base / d).is_dir()})

    missing = _missing()
    if missing:
        from .ensure import ensure_synthetic_dataset
        if ensure_synthetic_dataset(args.dataset, basepath):
            missing = _missing()
    if missing:
        raise FileNotFoundError(
            "Dataset directories missing for "
            f'"{args.dataset}": {missing}. Generate them first, e.g. '
            "python -m count_pipnet_tpu_torch.data.generate_shapes / "
            "generate_digits / preprocess_cub (see README.md Quick start).")


def device_augment_config(args):
    """The ``DeviceAugmentConfig`` of ``--device_augment`` (and
    ``--device_geometric``) for ``args.dataset``, or None. The two-view
    loaders then ship the t1 crop (with ``geo``, the raw decoded image) as
    uint8; color jitter + crop + noise + normalize (and the shared
    transform1) run on the card (data/device_augment.py). Supported for
    the synthetic recipes whose transform2 is purely photometric; others
    print the fallback to host augmentation."""
    if not getattr(args, "device_augment", False):
        return None
    synth = ("geometric_shapes", "geometric_shapes_gaussian_noise",
             "geometric_shapes_224_gaussian_noise", "mnist_counting",
             "shapes_200", "shapes_200_x4")
    if args.dataset not in synth:
        print(f"(--device_augment unsupported for {args.dataset}; "
              "using host augmentation)", flush=True)
        return None
    from .device_augment import DeviceAugmentConfig
    # shapes_200* use the gaussian-noise shapes recipe
    # (_shapes_recipe(s, True)) despite their names
    noisy = ("gaussian_noise" in args.dataset
             or args.dataset.startswith("shapes_200"))
    geo = bool(getattr(args, "device_geometric", False))
    if geo and args.dataset == "mnist_counting":
        # the MNIST recipe's transform1 is a RandomAffine with
        # translate/scale, not covered by the device geo path
        print("(--device_geometric unsupported for mnist_counting; "
              "shared transform1 stays on host)", flush=True)
        geo = False
    return DeviceAugmentConfig(
        img_size=args.image_size, brightness=0.1, contrast=0.1,
        noise_std=(0.1 if noisy else 0.0), noise_p=0.5,
        geo=geo, geo_rot=10.0, geo_out=args.image_size + 8,
        geo_scale=(0.95, 1.0), geo_fill=1.0,
        geo_canvas=args.image_size + 32)


def get_data(args, basepath="./"):
    """Build the dataset objects for a named dataset.

    Returns (trainset, trainset_pretraining, trainset_normal,
    trainset_normal_augment, projectset, testset, testset_projection,
    classes, num_channels, train_indices, targets) — the reference's
    create_datasets contract (util/data.py:218-259).
    """
    if args.dataset not in DATASET_RECIPES:
        raise ValueError(
            f'Could not load data set, data set "{args.dataset}" not found!')
    recipe_fn, (train_d, project_d, test_d, pretrain_d, test_proj_d,
                grayscale) = DATASET_RECIPES[args.dataset]
    base = Path(basepath)
    t1, t1p, t2 = recipe_fn(args.image_size)
    no_aug = _no_augment(args.image_size, grayscale=grayscale)

    device_aug_cfg = device_augment_config(args)
    t2_host = t2
    if device_aug_cfg is not None:
        # the host stops after t1 + decode; uint8 transport (4x fewer bytes
        # to the device, exactly ToArray's value once divided by 255)
        t2 = A.Compose([A.ToUint8Array()])

    cache = getattr(args, "cache_decoded", False)
    cache_dir = getattr(args, "decode_cache_dir", "")
    trainval = ImageFolder(base / train_d, cache_decoded=cache,
                           decode_cache_dir=cache_dir)
    classes = trainval.classes
    targets = trainval.targets
    train_indices = list(range(len(trainval)))

    if test_d is None:
        if args.validation_size <= 0.0:
            raise ValueError(
                "No test directory: validation_size must be > 0 so the "
                "training set can be split.")
        train_indices, test_indices = stratified_split(
            targets, args.validation_size, args.seed)
        testset = Subset(TransformedDataset(trainval, no_aug), test_indices)
    else:
        testset = TransformedDataset(
            ImageFolder(base / test_d, cache_decoded=cache,
                        decode_cache_dir=cache_dir), no_aug)

    # --device_geometric: the two-view loaders ship the raw decoded image
    # (the synthetic generators emit a uniform size); Resize + rotation +
    # RandomResizedCrop all run on the card as one resample inside the
    # shared transform1 (data/device_augment.apply_geo).
    # train_normal_augment below keeps the full host chain.
    t1_twoview = t1
    if device_aug_cfg is not None and device_aug_cfg.geo:
        t1_twoview = A.Compose([])

    trainset = Subset(
        TwoAugDataset(trainval, t1_twoview, t2,
                      single_view=device_aug_cfg is not None),
        train_indices)
    trainset.device_augment_cfg = device_aug_cfg
    trainset_normal = Subset(TransformedDataset(trainval, no_aug),
                             train_indices)
    both = A.Compose([t1, t2_host])
    trainset_normal_augment = Subset(TransformedDataset(trainval, both),
                                     train_indices)
    projectset = TransformedDataset(
        ImageFolder(base / project_d, cache_decoded=cache,
                    decode_cache_dir=cache_dir), no_aug)

    if test_proj_d is not None:
        testset_projection = TransformedDataset(
            ImageFolder(base / test_proj_d), no_aug)
    else:
        testset_projection = testset

    trainset_pretraining = None
    if pretrain_d is not None and t1p is not None:
        pre_base = ImageFolder(base / pretrain_d, cache_decoded=cache,
                               decode_cache_dir=cache_dir)
        pre_indices = list(range(len(pre_base)))
        if test_d is None:
            pre_indices, _ = stratified_split(
                pre_base.targets, args.validation_size, args.seed)
        trainset_pretraining = Subset(
            TwoAugDataset(pre_base, t1p, t2,
                          single_view=device_aug_cfg is not None),
            pre_indices)
        trainset_pretraining.device_augment_cfg = device_aug_cfg

    return (trainset, trainset_pretraining, trainset_normal,
            trainset_normal_augment, projectset, testset, testset_projection,
            classes, 3, train_indices, targets)


def get_dataloaders(args, basepath="./", test_set_projection_full=False):
    """The reference's 7-loader contract (util/data.py:111-216)."""
    (trainset, trainset_pretraining, trainset_normal,
     trainset_normal_augment, projectset, testset, testset_projection,
     classes, _num_ch, train_indices, targets) = get_data(args, basepath)

    sample_weights = None
    shuffle = True
    if args.weighted_loss:
        import numpy as np
        sub_targets = np.asarray(targets)[train_indices]
        sample_weights = make_weighted_sample_weights(sub_targets)
        shuffle = False

    common = dict(num_workers=args.num_workers, seed=args.seed)
    # a data-parallel world: the two training loaders (the only ones that
    # feed the rank-split train step) load this rank's slice of each
    # global batch; eval and projection stay global
    host_local = (dict(process_index=process_index(),
                       process_count=process_count())
                  if process_count() > 1 else {})
    trainloader = DataLoader(
        trainset, args.batch_size, shuffle=shuffle, drop_last=True,
        sample_weights=sample_weights, **common, **host_local)
    trainloader.device_augment_cfg = getattr(trainset,
                                             "device_augment_cfg", None)
    pre_set = trainset_pretraining or trainset
    trainloader_pretraining = DataLoader(
        pre_set, args.batch_size_pretrain, shuffle=shuffle, drop_last=True,
        sample_weights=sample_weights, **common, **host_local)
    trainloader_pretraining.device_augment_cfg = getattr(
        pre_set, "device_augment_cfg", None)
    trainloader_normal = DataLoader(
        trainset_normal, args.batch_size, shuffle=shuffle, drop_last=True,
        sample_weights=sample_weights, **common)
    trainloader_normal_augment = DataLoader(
        trainset_normal_augment, args.batch_size, shuffle=shuffle,
        drop_last=True, sample_weights=sample_weights, **common)
    # Projection runs batched on device (batch 64) — the reference's bs=1
    # loop (util/data.py:190-196) is a latency bottleneck it doesn't need.
    projectloader = DataLoader(
        projectset, 1, shuffle=False, drop_last=False, **common)
    testloader = DataLoader(
        testset, args.batch_size, shuffle=True, drop_last=False, **common)
    test_projectloader = DataLoader(
        testset_projection,
        args.batch_size if test_set_projection_full else 1,
        shuffle=False, drop_last=False, **common)

    print("Num classes (k) =", len(classes), classes[:5], "etc.", flush=True)
    return (trainloader, trainloader_pretraining, trainloader_normal,
            trainloader_normal_augment, projectloader, testloader,
            test_projectloader, classes)
