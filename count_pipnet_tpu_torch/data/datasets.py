"""Dataset primitives: ImageFolder scanning, two-view augmentation, subsets.

The port's copy of count_pipnet_tpu/data/datasets.py (framework-free host
code); Pillow is imported where an image is decoded.

Replaces torchvision.datasets.ImageFolder / torch Subset with plain
Python/PIL equivalents. Items are produced with an explicit per-item
``random.Random`` derived from (seed, epoch, index) — deterministic and
worker-count-independent, unlike the reference's broken worker seeding
(util/data.py:147).
"""

import os
import random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ImageFolder", "TwoAugDataset", "TransformedDataset", "Subset",
           "stratified_split", "IMG_EXTENSIONS"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


class ImageFolder:
    """Scan ``root/<class>/*`` into (path, class_idx) samples; classes are
    the sorted subdirectory names (torchvision ImageFolder contract)."""

    def __init__(self, root, transform: Optional[Callable] = None,
                 cache_decoded: bool = False, decode_cache_dir: str = ""):
        self.root = str(root)
        classes = sorted(
            d.name for d in os.scandir(self.root) if d.is_dir())
        if not classes:
            raise FileNotFoundError(
                f"no class directories under {self.root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(self.root, c)
            for dirpath, _, filenames in sorted(os.walk(cdir)):
                for fname in sorted(filenames):
                    if fname.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append(
                            (os.path.join(dirpath, fname),
                             self.class_to_idx[c]))
        self.imgs = self.samples
        self.targets = [t for _, t in self.samples]
        self.transform = transform
        # Decoded-image RAM cache (--cache_decoded): PNG/JPEG decode is a
        # large share of per-item host time on this 1-core box; decoded
        # frames are memoized as compact uint8 arrays (Image.fromarray on
        # re-access is ~free). Meant for the small fixed-size synthetic
        # datasets (~1.5 GB at 10k x 224^2); keep off for CUB-scale
        # native-resolution photos. Dict writes are GIL-atomic, so the
        # threaded loader at worst decodes an item twice.
        self._cache = {} if cache_decoded else None
        # Disk-persisted variant (--decode_cache_dir): one fingerprinted
        # memory-mapped .npy per image folder. Pays the decode pass once
        # per DATASET rather than once per process: chunked flagship runs
        # (scripts/train_chunked.py) restart a fresh process per chunk,
        # and get_data builds up to three ImageFolders over the SAME
        # train directory (registry.py) — all of which currently decode
        # into separate RAM dicts. The mmap is read-only and page-shared,
        # so it also replaces ~1.5 GB of per-process RSS at flagship
        # shape. Requires uniform decoded shapes; falls back to the RAM
        # dict otherwise (e.g. native-resolution photo sets).
        self._mm = None
        if cache_decoded and decode_cache_dir:
            self._mm = self._load_or_build_disk_cache(decode_cache_dir)
            if self._mm is not None:
                self._cache = None

    def _fingerprint(self) -> str:
        """Content fingerprint of the scanned samples: root-relative
        paths + file sizes + integer mtimes. Regenerating a dataset (new
        mtimes/sizes) or adding/removing files invalidates the cache."""
        import hashlib
        h = hashlib.sha1()
        for path, target in self.samples:
            st = os.stat(path)
            h.update(os.path.relpath(path, self.root).encode())
            h.update(f":{target}:{st.st_size}:{int(st.st_mtime)};".encode())
        return h.hexdigest()[:16]

    def _decode(self, index) -> np.ndarray:
        from PIL import Image
        path, _ = self.samples[index]
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), dtype=np.uint8)

    def _load_or_build_disk_cache(self, cache_dir: str):
        import json
        os.makedirs(cache_dir, exist_ok=True)
        tag = self._fingerprint()
        npy = os.path.join(cache_dir, f"imgcache_{tag}.npy")
        meta = npy + ".meta.json"
        if os.path.exists(npy) and os.path.exists(meta):
            try:
                with open(meta) as f:
                    m = json.load(f)
                arr = np.load(npy, mmap_mode="r")
                if (m.get("n") == len(self.samples)
                        and arr.shape[0] == len(self.samples)):
                    return arr
            except Exception as e:  # corrupt cache: rebuild below
                print(f"(decode cache {npy} unreadable: {e}; rebuilding)",
                      flush=True)
        from numpy.lib.format import open_memmap
        tmp = f"{npy}.{os.getpid()}.tmp"
        first = self._decode(0)
        try:
            mm = open_memmap(tmp, mode="w+", dtype=np.uint8,
                             shape=(len(self.samples),) + first.shape)
            mm[0] = first
            for i in range(1, len(self.samples)):
                a = self._decode(i)
                if a.shape != first.shape:
                    raise ValueError(
                        f"non-uniform image shapes ({a.shape} vs "
                        f"{first.shape})")
                mm[i] = a
            mm.flush()
            del mm
            os.replace(tmp, npy)
            with open(meta, "w") as f:
                json.dump({"n": len(self.samples),
                           "shape": list(first.shape)}, f)
            return np.load(npy, mmap_mode="r")
        except ValueError as e:
            print(f"(decode cache disabled for {self.root}: {e}; "
                  "using the in-RAM cache)", flush=True)
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def __len__(self):
        return len(self.samples)

    def load_image(self, index):
        from PIL import Image
        if self._mm is not None:
            # np.array copies out of the read-only mmap page; PIL needs
            # a writable, owned buffer and the copy (~150 KB) is noise
            # next to a decode
            return Image.fromarray(np.array(self._mm[index]))
        if self._cache is not None:
            arr = self._cache.get(index)
            if arr is not None:
                return Image.fromarray(arr)
        path, _ = self.samples[index]
        with Image.open(path) as img:
            out = img.convert("RGB")
        if self._cache is not None:
            self._cache[index] = np.asarray(out, dtype=np.uint8)
        return out

    def __getitem__(self, index_and_rng):
        index, rng = _split_index(index_and_rng)
        img = self.load_image(index)
        target = self.samples[index][1]
        if self.transform is not None:
            img = self.transform(img, rng)
        return img, target


def _split_index(index_and_rng):
    if isinstance(index_and_rng, tuple):
        return index_and_rng
    return index_and_rng, random.Random(0)


class TransformedDataset:
    """Apply a transform on top of a base dataset's raw PIL output."""

    def __init__(self, base: ImageFolder, transform: Callable):
        self.base = base
        self.classes = base.classes
        self.class_to_idx = base.class_to_idx
        self.targets = base.targets
        self.imgs = base.imgs
        self.transform = transform

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index_and_rng):
        index, rng = _split_index(index_and_rng)
        img = self.base.load_image(index)
        target = self.base.targets[index]
        return self.transform(img, rng), target


class TwoAugDataset:
    """Two-view contrastive item: shared geometric ``transform1``, then two
    independent photometric ``transform2`` draws
    (reference util/data.py:596-617).

    With ``single_view=True`` the item is ``(v1, target)``: used when the
    photometric second stage runs on the device (data/device_augment.py),
    so the host ships one array per sample instead of decoding, stacking
    and then discarding an identical second view."""

    def __init__(self, base: ImageFolder, transform1: Callable,
                 transform2: Callable, single_view: bool = False):
        self.base = base
        self.classes = base.classes
        self.class_to_idx = base.class_to_idx
        self.targets = base.targets
        self.imgs = base.imgs
        self.transform1 = transform1
        self.transform2 = transform2
        self.single_view = single_view

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index_and_rng):
        index, rng = _split_index(index_and_rng)
        img = self.base.load_image(index)
        target = self.base.targets[index]
        img = self.transform1(img, rng)
        v1 = self.transform2(img, rng)
        if self.single_view:
            return v1, target
        v2 = self.transform2(img, rng)
        return v1, v2, target


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)
        self.classes = getattr(dataset, "classes", None)
        self.class_to_idx = getattr(dataset, "class_to_idx", None)
        base_targets = getattr(dataset, "targets", None)
        self.targets = ([base_targets[i] for i in self.indices]
                        if base_targets is not None else None)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, index_and_rng):
        index, rng = _split_index(index_and_rng)
        return self.dataset[(self.indices[index], rng)]


def stratified_split(targets, test_size: float, seed: int):
    """Stratified train/test index split (sklearn-backed when available,
    mirroring the reference's train_test_split at util/data.py:227-233)."""
    indices = np.arange(len(targets))
    try:
        from sklearn.model_selection import train_test_split
        train_idx, test_idx = train_test_split(
            indices, test_size=test_size, stratify=np.asarray(targets),
            random_state=seed)
        return list(train_idx), list(test_idx)
    except ImportError:  # pragma: no cover
        rng = np.random.default_rng(seed)
        targets = np.asarray(targets)
        train_idx, test_idx = [], []
        for c in np.unique(targets):
            cls_idx = indices[targets == c]
            rng.shuffle(cls_idx)
            n_test = int(round(len(cls_idx) * test_size))
            test_idx.extend(cls_idx[:n_test])
            train_idx.extend(cls_idx[n_test:])
        return sorted(train_idx), sorted(test_idx)
