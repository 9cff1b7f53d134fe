"""ctypes bindings for the port's native batch-assembly library.

The port's own copy of count_pipnet_tpu/native/__init__.py (host code, no
framework). ``batch_ops.cpp`` is built with the system C++ compiler at
first use into ``_build/`` beside it (ignored by git), named by a hash of
the source and the flags, so an edit rebuilds and concurrent builds by
several processes each write their own file and rename it into place. The
flags carry no ``-march=native``: a checkout copied to another machine
reuses the library. Without a compiler the callers get the numpy path, and
the first call prints why.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["normalize_batch", "stack_batch", "native_available"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "batch_ops.cpp"
_BUILD = _HERE / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path():
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD / f"libbatch_ops_{h.hexdigest()[:16]}.so"


def _build(path):
    _BUILD.mkdir(exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["c++", *_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
                   check=True, capture_output=True)
    os.replace(tmp, path)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = _lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.normalize_batch_u8.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.stack_batch_f32.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int]
            _lib = lib
        except Exception as e:
            print(f"(native batch ops unavailable, using numpy: {e})")
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def _ptrs(arrays):
    return (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def normalize_batch(images, mean, std, n_threads=4):
    """uint8 HWC image list -> normalized float32 NHWC batch."""
    lib = _load()
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    imgs = [np.ascontiguousarray(im, np.uint8) for im in images]
    h, w, _ = imgs[0].shape
    out = np.empty((len(imgs), h, w, 3), np.float32)
    if lib is None:
        np.divide(np.stack(imgs), 255.0, out=out)
        out -= mean
        out /= std
        return out
    lib.normalize_batch_u8(_ptrs(imgs), len(imgs), h, w, _f32p(mean),
                           _f32p(std), _f32p(out), n_threads)
    return out


def stack_batch(images, n_threads=4):
    """float32 array list -> contiguous stacked batch (parallel memcpy)."""
    lib = _load()
    imgs = [np.ascontiguousarray(im, np.float32) for im in images]
    if lib is None:
        return np.stack(imgs)
    out = np.empty((len(imgs),) + imgs[0].shape, np.float32)
    lib.stack_batch_f32(_ptrs(imgs), len(imgs), int(np.prod(imgs[0].shape)),
                        _f32p(out), n_threads)
    return out
