#!/usr/bin/env python3
"""Print each stand-in's greedy ratio under the plain reference encoder
beside the ratio the mix aims at (``target_ratio`` of each file).

Usage: python3 portbench/calibrate.py [mix] [seed ...]

Runs on the CPU: one copy of the mix per seed, each file through
:func:`portbench.reference.snappy_plain.compress` (preamble included).
"""

from __future__ import annotations

import json
import pathlib
import statistics
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import generator  # noqa: E402
from portbench.reference import snappy_plain  # noqa: E402


def ratios(mix: dict, seeds: list[int]) -> dict[str, list[float]]:
    out = {f["name"]: [] for f in mix["files"]}
    for seed in seeds:
        made = generator.files(mix, seed, 1, "cpu")
        for f in mix["files"]:
            data = made[f["name"]][0].numpy().tobytes()
            out[f["name"]].append(len(snappy_plain.compress(data)) / len(data))
    return out


def main(argv: list[str]) -> int:
    name = argv[0] if argv else "corpus"
    seeds = [int(s) for s in argv[1:]] or [1, 2, 3]
    mix = generator.load_mix(name)
    got = ratios(mix, seeds)
    total_in = sum(f["length"] for f in mix["files"])
    total_out = 0.0
    for f in mix["files"]:
        r = got[f["name"]]
        total_out += statistics.mean(r) * f["length"]
        print(json.dumps({"file": f["name"], "n": f["length"], "greedy": [round(x, 4) for x in r],
                          "target": f.get("target_ratio")}))
    print(json.dumps({"mix": name, "seeds": seeds, "greedy_all": round(total_out / total_in, 4)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
