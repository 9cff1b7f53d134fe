"""Import and packaging guard of the PyTorch port: every module of
count_pipnet_tpu_torch imports with JAX, msgpack and sklearn made
unimportable (the card's machine has none of them), loads neither flax
nor the JAX package, and the CUDA sources ship with the package."""

import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "count_pipnet_tpu_torch"

_PROBE = """
import pkgutil, sys
for blocked in ("jax", "msgpack", "sklearn"):
    sys.modules[blocked] = None
import count_pipnet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "count_pipnet_tpu", "msgpack",
                              "sklearn")
       and sys.modules[m] is not None]
print(len(names), bad)
assert not bad, bad
# the data-parallel modules, the native assembler and the dry run too
for mod in ("parallel.distributed", "parallel.mesh", "native", "dryrun"):
    assert pkg.__name__ + "." + mod in names, mod
# the repo tools' counterparts and the acceptance runner
for mod in ("receptive_field_analysis", "visualize_augmented_samples",
            "validate_pretrained", "train_chunked", "acceptance_run"):
    assert pkg.__name__ + ".scripts." + mod in names, mod
"""


def test_port_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 15, res.stdout


def test_cuda_sources_tracked_and_packaged():
    from count_pipnet_tpu_torch.ops import cuda as kc
    sources = sorted(p.relative_to(ROOT).as_posix()
                     for p in (PKG / "ops" / "cuda").glob("*.cu*"))
    # every source on disk is one the build compiles or hashes
    assert [pathlib.PurePath(p).name for p in sources] == sorted(
        kc.SOURCES + kc.HEADERS), sources
    if not (ROOT / ".git").exists():
        pytest.skip("not a git checkout")
    tracked = subprocess.run(
        ["git", "ls-files", "--error-unmatch", *sources], cwd=ROOT,
        capture_output=True, text=True)
    assert tracked.returncode == 0, tracked.stderr
    ignored = subprocess.run(
        ["git", "check-ignore", "-q",
         "count_pipnet_tpu_torch/ops/cuda/_build/x.so"], cwd=ROOT)
    assert ignored.returncode == 0, "the kernel build dir must be ignored"
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert '"count_pipnet_tpu_torch.ops.cuda" = ["*.cu", "*.cuh"]' \
        in pyproject


def test_native_source_tracked_and_packaged():
    """The batch assembler's C++ source ships with the package; what it
    builds lands in an ignored directory."""
    assert '"count_pipnet_tpu_torch.native" = ["*.cpp"]' in (
        ROOT / "pyproject.toml").read_text()
    if not (ROOT / ".git").exists():
        pytest.skip("not a git checkout")
    src = "count_pipnet_tpu_torch/native/batch_ops.cpp"
    tracked = subprocess.run(["git", "ls-files", "--error-unmatch", src],
                             cwd=ROOT, capture_output=True, text=True)
    assert tracked.returncode == 0, tracked.stderr
    ignored = subprocess.run(
        ["git", "check-ignore", "-q",
         "count_pipnet_tpu_torch/native/_build/libbatch_ops_0.so"], cwd=ROOT)
    assert ignored.returncode == 0, "the native build dir must be ignored"
