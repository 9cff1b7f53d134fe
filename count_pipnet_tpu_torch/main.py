"""Command-line entry of the port: train a Count-PIPNet.

    python -m count_pipnet_tpu_torch.main --model count_pipnet [flags...]

The flags and defaults are the JAX package's ``main.py`` (see
count_pipnet_tpu_torch/config.py). It needs a CUDA device unless
``--disable_cuda`` selects the CPU. stdout is mirrored into
``<log_dir>/out.txt`` and stderr into ``<log_dir>/tqdm.txt``; a failure
prints its traceback and exits non-zero.

Data parallelism (parallel/): ``--mesh_shape N`` with N > 1 spawns N ranks
(the spawn start method: a fork after CUDA is initialised breaks it),
joined through a ``file://`` store in a temporary directory: rank i on
``cuda:i`` with NCCL, or with ``--disable_cuda`` N gloo ranks on the CPU.
N above the CUDA devices raises the JAX package's ``make_mesh`` error.
Under torchrun (``WORLD_SIZE`` > 1) each process joins the world instead,
and ``--mesh_shape`` must be -1 or the world size. Only rank 0 mirrors its
streams into the run directory.
"""

import os
import shutil
import sys
import tempfile
import traceback

import torch

from .config import get_args
from .parallel import distributed
from .parallel.mesh import check_mesh_size
from .train.trainer import run_pipnet
from .utils.log import tee_std_streams


def _run(args):
    """``run_pipnet`` with rank 0's streams mirrored into the run dir."""
    restore = None
    if distributed.process_index() == 0:
        os.makedirs(args.log_dir, exist_ok=True)
        restore = tee_std_streams(
            args.log_dir, append=getattr(args, "resume_training", False))
    try:
        run_pipnet(args)
    except Exception as e:
        print(f"Error: {e}")
        traceback.print_exc()
        raise
    finally:
        if restore is not None:
            restore()


def _rank(rank, args, world_size, store):
    """One spawned rank of ``--mesh_shape N``."""
    distributed.maybe_initialize(
        init_method=f"file://{store}", world_size=world_size, rank=rank,
        device_type="cpu" if args.disable_cuda else "cuda")
    try:
        _run(args)
    finally:
        distributed.shutdown()


def main(argv=None):
    args = get_args(argv)
    if not args.disable_cuda and not torch.cuda.is_available():
        print("error: no CUDA device; pass --disable_cuda to train on the "
              "CPU", file=sys.stderr)
        return 2
    n = args.mesh_shape
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # torchrun's processes
        distributed.maybe_initialize(
            device_type="cpu" if args.disable_cuda else "cuda")
        try:
            _run(args)
        finally:
            distributed.shutdown()
    elif n > 1:
        if not args.disable_cuda:
            check_mesh_size(n, torch.cuda.device_count())
        store_dir = tempfile.mkdtemp(prefix="cpt_world_")
        try:
            torch.multiprocessing.start_processes(
                _rank, args=(args, n, os.path.join(store_dir, "store")),
                nprocs=n, start_method="spawn")
        finally:
            shutil.rmtree(store_dir, ignore_errors=True)
    else:
        _run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
