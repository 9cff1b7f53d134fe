"""Run logging: schema-checked CSV logs + stdout tee.

The port's copy of count_pipnet_tpu/utils/log.py (framework-free).
Reference: util/log.py (Log with create_log/log_values arity checking) and
main.py:513-537 (Tee of stdout/stderr into out.txt / tqdm.txt).
"""

import os
import sys

__all__ = ["Log", "Tee"]


class Log:
    """Owns a run directory with ``metadata/`` and ``checkpoints/``
    subdirectories and schema-checked CSV logs."""

    def __init__(self, log_dir: str):
        self._log_dir = log_dir
        self._logs = {}
        os.makedirs(log_dir, exist_ok=True)
        os.makedirs(self.metadata_dir, exist_ok=True)
        os.makedirs(self.checkpoint_dir, exist_ok=True)

    @property
    def log_dir(self):
        return self._log_dir

    @property
    def metadata_dir(self):
        return os.path.join(self._log_dir, "metadata")

    @property
    def checkpoint_dir(self):
        return os.path.join(self._log_dir, "checkpoints")

    def create_log(self, log_name: str, key_name: str, *value_names,
                   append: bool = False):
        """Create a CSV with header ``key_name,value_names...``.

        ``append=True`` (a resumed or chunked run re-registering its
        log): if the file already exists with the IDENTICAL header, the
        existing rows are kept and new values append — unlike the
        reference, whose create_log truncates on resume
        (util/log.py:48-61). Non-resumed runs always truncate, so a
        fresh run reusing a log_dir does not interleave with a previous
        run's rows."""
        if log_name in self._logs:
            raise KeyError(f"Log '{log_name}' already exists")
        self._logs[log_name] = (key_name, value_names)
        header = ",".join((key_name,) + value_names)
        path = os.path.join(self._log_dir, f"{log_name}.csv")
        if append and os.path.exists(path):
            with open(path) as f:
                if f.readline().rstrip("\n") == header:
                    return  # keep history, append from here
        with open(path, "w") as f:
            f.write(header + "\n")

    def log_values(self, log_name: str, key, *values):
        if log_name not in self._logs:
            raise KeyError(f"Log '{log_name}' does not exist")
        expected = len(self._logs[log_name][1])
        if len(values) != expected:
            raise ValueError(
                f"Log '{log_name}' expects {expected} values, got "
                f"{len(values)}")
        with open(os.path.join(self._log_dir, f"{log_name}.csv"), "a") as f:
            f.write(",".join(str(v) for v in (key,) + values) + "\n")


class Tee:
    """Mirror a stream into a file (main.py:514-525)."""

    def __init__(self, stream, file):
        self.stream = stream
        self.file = file

    def write(self, message):
        self.stream.write(message)
        self.file.write(message)

    def flush(self):
        self.stream.flush()
        self.file.flush()


def tee_std_streams(log_dir, suffix="", append=False):
    """Route stdout -> out.txt and stderr -> tqdm.txt like the reference
    entrypoint (main.py:508-537). Returns a restore() callable.

    ``suffix`` separates per-process files; ``append`` keeps the previous
    process's history (resumed runs)."""
    mode = "a" if append else "w"
    out_file = open(os.path.join(log_dir, f"out.txt{suffix}"), mode)
    err_file = open(os.path.join(log_dir, f"tqdm.txt{suffix}"), mode)
    orig_out, orig_err = sys.stdout, sys.stderr
    sys.stdout = Tee(orig_out, out_file)
    sys.stderr = Tee(orig_err, err_file)

    def restore():
        sys.stdout = orig_out
        sys.stderr = orig_err
        out_file.close()
        err_file.close()

    return restore
