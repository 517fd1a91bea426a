#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one cell, one run.

Usage (from the root of a checkout):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``portbench/configs/<config>.json``, whose ``entry`` names the driver
``portbench/drivers/<entry>.py``) under a traffic mix
(``portbench/traffic/<mix>.json``, read by ``portbench/generator.py``).
Each metric is read by ``portbench/metrics/<metric>.py``. All of these are
found by name, so a new cell, mix or metric is a new file and a new entry.

A run makes its inputs from the seed, warms up every shape it uses (the
set-up, ``setup_s``), measures for ``--seconds``, and then checks the
outputs of the window's calls against the plain reference
(``portbench/reference``). With ``--trace 1`` the window runs under
``torch.profiler`` and the line carries the per-layer metrics, the
device's busy time and a breakdown; with ``--trace 0`` the end-to-end
metrics. The last line of standard output is one JSON object; the numbers
the check compared, each beside its limit, are the last lines of standard
error and the last key of that object.

It refuses to run (exit 2, no result) without as many CUDA devices as the
cell asks for, and fails (exit 3, no result) if JAX or the JAX package is
loaded in the process when the result is due.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # before the heavy imports: set-up counts them

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import random  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

from portbench import generator, trace  # noqa: E402

#: Top-level module names that must not be loaded in a run, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "snappier_tpu")


def load_spec(root: pathlib.Path) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def load_module(path: pathlib.Path):
    name = "portbench_" + re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Record:
    """What the metric readers read: the window's phases and calls, each
    with its bytes and host times (and, traced, its trace interval, busy
    seconds and kernel seconds), and the set-up time."""

    def __init__(self, phases: list, calls: list, setup_s: float, own_kernels: list[str]):
        self.phases, self.calls, self.setup_s = phases, calls, setup_s
        self._own = re.compile("|".join(rf"(?<![A-Za-z0-9_]){re.escape(k)}(?![A-Za-z0-9_])"
                                        for k in own_kernels))

    def is_own_kernel(self, name: str) -> bool:
        return bool(self._own.search(name))


def _power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def cell_spec(spec: dict, workload: str) -> tuple[dict, dict]:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    return w, {c["name"]: c for c in spec["configs"]}[w["config"]]


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
             program=None, root: pathlib.Path = HERE, t_start: float = T_START) -> dict:
    """One run of one cell; returns the result object. ``program`` builds
    the system under test from (config, device); by default the driver's
    ``Program``."""
    spec = load_spec(root)
    w, c = cell_spec(spec, workload)
    cfg = json.loads((root.parent / c["file"]).read_text())
    mix = generator.load_mix(w["traffic"], root)
    drv = load_module(root / "drivers" / f"{cfg['entry']}.py")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    prog = (program or drv.Program)(cfg, dev)
    rng = random.Random(generator.subseed(seed, "check"))
    cell = drv.Cell(cfg, mix, seed, dev, prog, rng, lambda name: trace.span(name, traced))
    setup_s = time.perf_counter() - t_start

    info = None
    if traced:
        with trace.profiled(dev) as tr:
            cell.window(seconds)
        info = trace.annotate(cell.phases, tr.events)
    else:
        cell.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    cell.free_program()
    prog = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, failed = cell.check()
    check_s = time.perf_counter() - t_check
    correct = all(v <= lim for v, lim in numbers.values())

    own = json.loads((root / "own_kernels.json").read_text())["kernels"]
    rec = Record(cell.phases, cell.calls, setup_s, own)
    metrics = {}
    for m in spec["per_layer" if traced else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = load_module(root / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    devinfo = {"platform": "gpu" if dev.type == "cuda" else "cpu",
               "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "count": 1, "memory_peak_bytes": peak}
    if dev.type == "cuda":
        devinfo["power_limit_w"] = _power_limit_w()
    result = {"correct": correct, "attempted": cell.attempted, "failed": failed,
              "metrics": metrics, "device": devinfo}
    if info is not None:
        devinfo["busy_s"], devinfo["window_s"] = info["busy_s"], info["window_s"]
        result["breakdown"] = info["breakdown"]
    result["check_s"] = check_s
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    w, _ = cell_spec(load_spec(HERE), args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < w["chips"]:
        print(f"portbench: the cell needs {w['chips']} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        return 2
    return finish(run_cell(args.workload, args.seed, args.seconds, bool(args.trace)))


def finish(result: dict) -> int:
    """Print the result, unless JAX or the JAX package is loaded by now
    (exit 3, no result): the look comes last, after the check and the
    metric readers, so it sees whatever any of them loaded."""
    found = forbidden_modules()
    if found:
        print("portbench: loaded in the run: " + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
