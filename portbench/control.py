#!/usr/bin/env python3
"""Run a cell with its driver's ``Control`` in the program's place: the
plain reference with one guarantee broken (a match taken on a hash
without comparing bytes), which the check has to call not correct.

Usage (from the root of a checkout, on the card):

    python3 portbench/control.py --workload <cell> --seconds <s> [--key-bits N] SEED...

``--key-bits 0`` compares bytes exactly: the sound reference codec, which
the check has to pass. One JSON line per seed with ``correct`` and the
numbers the check compared; the benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402


def control_program(workload: str, key_bits: int | None, root=run.HERE):
    spec = run.load_spec(root)
    _, c = run.cell_spec(spec, workload)
    cfg = json.loads((root.parent / c["file"]).read_text())
    drv = run.load_module(root / "drivers" / f"{cfg['entry']}.py")
    return functools.partial(drv.Control, key_bits=key_bits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run a cell with the control in the program's place.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--key-bits", type=int, default=16)
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    prog = control_program(args.workload, args.key_bits or None)
    for seed in args.seeds:
        t = time.perf_counter()
        r = run.run_cell(args.workload, seed, args.seconds, False, program=prog, t_start=t)
        print(json.dumps({"workload": args.workload, "seed": seed, "key_bits": args.key_bits,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
