"""Command-line entry of the port: train a Count-PIPNet.

    python -m count_pipnet_tpu_torch.main --model count_pipnet [flags...]

The flags and defaults are the JAX package's ``main.py`` (see
count_pipnet_tpu_torch/config.py). It needs a CUDA device unless
``--disable_cuda`` selects the CPU. stdout is mirrored into
``<log_dir>/out.txt`` and stderr into ``<log_dir>/tqdm.txt``; a failure
prints its traceback and exits non-zero.
"""

import os
import sys
import traceback

import torch

from .config import get_args
from .train.trainer import run_pipnet
from .utils.log import tee_std_streams


def main(argv=None):
    args = get_args(argv)
    if not args.disable_cuda and not torch.cuda.is_available():
        print("error: no CUDA device; pass --disable_cuda to train on the "
              "CPU", file=sys.stderr)
        return 2
    os.makedirs(args.log_dir, exist_ok=True)
    restore = tee_std_streams(args.log_dir,
                              append=getattr(args, "resume_training", False))
    try:
        run_pipnet(args)
    except Exception as e:
        print(f"Error: {e}")
        traceback.print_exc()
        raise
    finally:
        restore()
    return 0


if __name__ == "__main__":
    sys.exit(main())
