"""Helpers of the benchmark's CPU tests: a copy of the benchmark with its
cells cut to a size the program's plain versions finish in a second."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"block_codec": {"rows_per_call": 4, "pool_batches": 2, "compress_calls_per_phase": 1,
                        "decompress_calls_per_phase": 2, "check_calls": 2},
        "facade": {"object_bytes": 1 << 17, "pool_objects": 2, "check_calls": 2}}
SEED = 2**31 + 12345  # a seed past 32 signed bits, as the driver's are


def tiny_root(tmp: pathlib.Path, spec_edit=None) -> pathlib.Path:
    """Copy the benchmark under ``tmp`` with every cell cut down; returns
    the copy's ``portbench`` directory. ``spec_edit`` may change the
    copied ``BENCHMARK.json`` (a dict) in place."""
    tmp = pathlib.Path(tmp)
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TINY[cfg["entry"]])
        (tmp / c["file"]).write_text(json.dumps(cfg))
    if spec_edit:
        spec_edit(spec)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp / "portbench"


def run_tiny(root: pathlib.Path, workload: str, traced: bool = False, program=None,
             seconds: float = 0.2, seed: int = SEED) -> dict:
    from portbench import run

    return run.run_cell(workload, seed, seconds, traced, device="cpu", program=program,
                        root=root, t_start=time.perf_counter())


def cells() -> list[str]:
    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
