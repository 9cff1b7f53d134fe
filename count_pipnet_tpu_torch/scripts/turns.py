"""Compares two checkouts on one CUDA card in turns: runs ``chip_smoke.py``
of the parent checkout, then of this one twice, then of the parent again
(parent, change, change, parent), each from its own root, and prints every
timing line's numbers (``time ...``, serving throughput, training steps)
from the four runs side by side, then nvcc's registers, stack and spills
of every kernel entry in the two builds.

    python3 -m count_pipnet_tpu_torch.scripts.turns --parent DIR \\
        [--phases device,build,kernels] [--parent-phases ...] \\
        [--out chiprun_out/turns]

``DIR`` is an unpacked ``git archive`` of the parent commit. Each run's
output and both builds' nvcc logs go to ``--out``; a run that fails stops
the comparison. ``--builds-only`` compares the saved logs again.
"""

import argparse
import re
import subprocess
import sys
from pathlib import Path

from count_pipnet_tpu_torch.ops.cuda import ptxas_entries

ROOT = Path(__file__).resolve().parents[2]
CARD = re.compile(r"\s*\([^()]*\bW\)\s*$")  # "(<card>, <limit> W)"
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
TIMED = ("time ", "infer throughput", "variants throughput", "train step")


def readings(text):
    """{line key: [numbers]} of the timing lines of one run (``time ...``,
    the serving throughputs, the training steps); the key is the line up
    to its first colon."""
    out = {}
    for line in text.splitlines():
        if not line.startswith(TIMED) or ":" not in line:
            continue
        key, rest = line.split(":", 1)
        out[key] = [float(v) for v in NUMBER.findall(CARD.sub("", rest))]
    return out


def build_log(tree):
    logs = sorted((tree / "count_pipnet_tpu_torch" / "ops" / "cuda"
                   / "_build").glob("*.log"), key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""


# Template arguments renamed since an entry's earlier form, so that the two
# builds' entries match: the K-major GEMM core's operand type (bf16 unless
# s8; a template argument since the s8 mode) and kernel A's prologue mode
# (a bool until it gained the dynamic mode)
RENAMES = ((re.compile(r"^(void cpt::sm90::gemm_kernel<.*), __nv_bfloat16>$"),
            r"\1>"),
           (re.compile(r"(block_prologue_kernel<[^,]+, )true,"), r"\g<1>1,"),
           (re.compile(r"(block_prologue_kernel<[^,]+, )false,"), r"\g<1>0,"))


def without_parameters(name):
    """A demangled entry's name without its parameter list (which moves
    with the kernel's arguments)."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0 and name[i] == "(":
            return name[:i]
    return name


def by_name(log):
    """ptxas_entries of a build log by name, without parameter lists and
    with RENAMES applied, so that an entry matches its earlier form."""
    out = {}
    for name, e in ptxas_entries(log).items():
        name = without_parameters(name).replace("> >", ">>")
        for pattern, repl in RENAMES:
            name = pattern.sub(repl, name)
        out[name] = e
    return out


def compare_builds(out):
    """Registers, stack and spills of every kernel entry in the two builds
    whose logs a run saved in ``out``."""
    before = by_name((out / "parent_build.log").read_text())
    after = by_name((out / "change_build.log").read_text())
    for name in dict.fromkeys(list(before) + list(after)):
        b, a = before.get(name), after.get(name)
        fmt = lambda e: ("-" if e is None else  # noqa: E731
                         f"{e[0]} regs, {e[1]} B stack, spills {e[2]}/{e[3]}")
        print(f"ptxas {'same' if a == b else 'moved'}: parent {fmt(b)}; "
              f"change {fmt(a)}: {name[:160]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--phases", default="device,build,kernels")
    ap.add_argument("--parent-phases", default=None,
                    help="the parent's phases (default: --phases)")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "turns")
    ap.add_argument("--builds-only", action="store_true",
                    help="compare the two builds' logs a run saved in --out "
                    "again, without running anything (needs no card)")
    args = ap.parse_args(argv)
    if args.builds_only:
        compare_builds(args.out)
        return 0
    args.out.mkdir(parents=True, exist_ok=True)
    trees = {"parent": (args.parent.resolve(),
                        args.parent_phases or args.phases),
             "change": (ROOT, args.phases)}
    runs = []
    for i, which in enumerate(("parent", "change", "change", "parent")):
        tree, phases = trees[which]
        res = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                              phases], cwd=tree, capture_output=True,
                             text=True)
        (args.out / f"{i}_{which}.log").write_text(res.stdout + res.stderr)
        print(f"turn {i} ({which}): exit {res.returncode}", flush=True)
        if res.returncode:
            print(res.stdout[-3000:] + res.stderr[-3000:])
            return 1
        runs.append((which, readings(res.stdout)))
    keys = list(dict.fromkeys(k for _, r in runs for k in r))
    for key in keys:
        cols = [" ".join(f"{v:g}" for v in r.get(key, [])) or "-"
                for _, r in runs]
        print(f"turns {key}: parent [{cols[0]}] | change [{cols[1]}] | "
              f"change [{cols[2]}] | parent [{cols[3]}]")
    for which, (tree, _) in trees.items():
        (args.out / f"{which}_build.log").write_text(build_log(tree))
    compare_builds(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
