"""Readings that the limits of ``correct`` are set from, each a whole run of
the cell through the harness's own comparison (pbcore.session.run_cell):
with ``--system program`` the port, with ``--system control`` the control
in its place (pbcore.systems: the plain reference in float32, every
stage's result stored in bfloat16), which has to come out not correct.

    python3 portbench/control.py --workload <name> --system control --seeds <n> [<n> ...]

Needs a CUDA device unless ``--device cpu``. One JSON line a seed on
stdout: the seed, the system, ``correct`` and the numbers compared beside
their limits. Exits 1 if a control run came out correct or a program run
did not. The benchmark's runs do not run this."""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--system", choices=("program", "control"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]
    import torch

    from pbcore.session import run_cell
    from pbcore.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    wrong = 0
    for seed in args.seeds:
        out = run_cell(cell, seed, args.seconds, False, args.device, system=args.system)
        print(json.dumps({"workload": cell.name, "seed": seed, "system": args.system,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "check": out["check"]}), flush=True)
        wrong += out["correct"] != (args.system == "program")
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
