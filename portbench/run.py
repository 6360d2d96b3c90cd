"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Reads BENCHMARK.json, finds the cell's
configuration (configs/), traffic mix (traffic/), the loop the mix names
(loops/) and a reader for each metric (metrics/) by name, runs
meshopticalflow_tpu_torch on the first CUDA device, checks its answers
against the plain reference (pbref/) and prints one JSON line last on
stdout: the end-to-end metrics with --trace 0, the
per-layer metrics, busy and window seconds and the breakdown with
--trace 1. The device and its clocks and power limit go to stderr first;
the numbers compared, each beside its limit, are stderr's last lines and
the result's last key.

Exit codes: 0 a result (correct or not), 1 the run failed, 2 the cell or a
file it names is malformed, 3 no CUDA device or fewer than the cell asks
for, 4 the process loaded JAX or the JAX package."""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "meshopticalflow_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the part before the first dot, compared whole)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]
    from pbcore.spec import SpecError, load_cell

    try:
        cell = load_cell(ROOT, args.workload)
    except SpecError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), this machine has "
              f"{n}", file=sys.stderr)
        return 3
    print(f"portbench: {cell.name} seed {args.seed}; device {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    from pbcore.session import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}; no result", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
