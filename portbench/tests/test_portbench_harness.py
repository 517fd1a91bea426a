"""The harness: each cell end to end at a tiny size on the CPU (the
program's plain versions), the contract's result line, files found by
name, the modules a run loads, and ``BENCHMARK.json`` against the
contract."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
import torch

from portbench_tiny import REPO, SEED, cells, run_tiny, tiny_root

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _metrics_of(workload: str, kind: str) -> set[str]:
    return {m["name"] for m in SPEC[kind] if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_cell_runs_tiny(tmp_path, workload, traced):
    root = tiny_root(tmp_path)
    r = run_tiny(root, workload, traced)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    if traced:
        assert set(r["metrics"]) <= _metrics_of(workload, "per_layer")
        assert r["device"]["window_s"] > 0 and "busy_s" in r["device"]
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == _metrics_of(workload, "end_to_end")
        assert all(m["value"] > 0 for m in r["metrics"].values())
    json.dumps(r)


def test_same_seed_same_inputs(tmp_path):
    root = tiny_root(tmp_path)
    a = run_tiny(root, "block-corpus", seconds=0.0)
    b = run_tiny(root, "block-corpus", seconds=0.0)
    assert a["metrics"]["stored_ratio"] == b["metrics"]["stored_ratio"]


def test_new_config_mix_and_metric_found_by_name(tmp_path):
    """A later change adds a configuration, a traffic mix and a metric as
    new files and new entries, and edits no file that is there."""

    def add(spec):
        spec["configs"].append({"name": "block-batch-16k", "source": "https://example.org/x",
                                "file": "portbench/configs/block-batch-16k.json",
                                "reduced": [], "why": "16 KiB blocks"})
        spec["workloads"].append({"name": "block-incompressible", "config": "block-batch-16k",
                                  "traffic": "incompressible", "chips": 1,
                                  "why": "uniform random rows: the tag walks bypassed"})
        spec["per_layer"].append({"name": "phases_per_s", "unit": "1/s", "better": "higher",
                                  "source": "program_counter", "layer": "codec API",
                                  "moves": "compress_gbps", "workloads": ["block-incompressible"]})

    root = tiny_root(tmp_path, add)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "block-batch-64k.json").read_text())
    cfg.update(name="block-batch-16k", fragment=16384, reduced={})
    (root / "configs" / "block-batch-16k.json").write_text(json.dumps(cfg))
    (root / "traffic" / "incompressible.json").write_text(json.dumps({"files": [
        {"name": "media", "length": 3 * 65536 + 5, "model": "random"}]}))
    (root / "metrics" / "phases_per_s.py").write_text(
        "def read(rec):\n"
        "    secs = sum(p['t1'] - p['t0'] for p in rec.phases)\n"
        "    return len(rec.phases) / secs if secs > 0 else None\n")
    r = run_tiny(root, "block-incompressible", traced=True)
    assert r["correct"] and r["metrics"]["phases_per_s"]["value"] > 0
    assert {p: p.read_bytes() for p in before} == before
    e2e = run_tiny(root, "block-incompressible")
    assert e2e["metrics"]["stored_ratio"]["value"] > 1.0  # random rows do not shrink


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI runs instead of refusing")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "block-corpus", "--seed",
                        str(SEED), "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and r.stdout == "" and "CUDA" in r.stderr


def test_fails_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    prints no result: the program is missing."""
    tiny_root(tmp_path)
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from portbench import run\n"
            "r = run.run_cell('block-corpus', 1, 0.1, False, device='cpu', "
            "t_start=time.perf_counter())\n"
            "print(r)\n") % str(tmp_path)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "snappier_tpu_torch" in r.stderr


@pytest.mark.parametrize("workload", cells())
def test_run_loads_no_jax(tmp_path, workload):
    """A run in a fresh process loads no module whose top-level name is
    jax, jaxlib, flax or snappier_tpu (snappier_tpu_torch is the program),
    and the harness's last look before the result finds one planted before
    the run or imported by a metric reader after the window: exit 3, no
    result line."""

    def add_probe(spec):
        spec["end_to_end"].append({"name": "jax_probe", "unit": "s", "better": "lower",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": [workload]})

    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    clean = tiny_root(tmp_path / "clean")
    probed = tiny_root(tmp_path / "probed", add_probe)
    (probed / "metrics" / "jax_probe.py").write_text(
        "import sys\n\n\ndef read(rec):\n"
        "    sys.path.insert(0, %r)\n    import jax  # noqa: F401\n    return 1.0\n" % str(stub))
    code = (
        "import pathlib, sys, time; sys.path.insert(0, sys.argv[1]); sys.path.insert(1, %r)\n"
        "from portbench import run\n"
        "if sys.argv[2] == 'planted':\n"
        "    sys.modules['jax'] = type(sys)('jax')\n"
        "r = run.run_cell(%r, %d, 0.1, False, device='cpu', root=pathlib.Path(sys.argv[1])"
        " / 'portbench', t_start=time.perf_counter())\n"
        "assert r['correct'], r\n"
        "loaded = sorted({m.split('.')[0] for m in sys.modules})\n"
        "assert 'snappier_tpu_torch' in loaded\n"
        "if sys.argv[2] == 'clean':\n"
        "    assert not [m for m in loaded if m in ('jax', 'jaxlib', 'flax', 'snappier_tpu')]\n"
        "sys.exit(run.finish(r))\n"
    ) % (str(REPO), workload, SEED)

    def go(root, how):
        return subprocess.run([sys.executable, "-c", code, str(root.parent), how],
                              capture_output=True, text=True, timeout=600)

    r = go(clean, "clean")
    assert r.returncode == 0, r.stdout + r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
    for root, how in ((clean, "planted"), (probed, "probed")):
        r = go(root, how)
        assert r.returncode == 3 and r.stdout == "", (how, r.stdout + r.stderr)
        assert "loaded in the run: jax" in r.stderr, (how, r.stderr)


def test_benchmark_json_meets_the_contract():
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(SPEC) == keys
    assert SPEC["paths"] == ["portbench"] and SPEC["command"][:2] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    cfgs = {c["name"]: c for c in SPEC["configs"]}
    assert len(cfgs) == len(SPEC["configs"])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/configs/") and (REPO / c["file"]).is_file()
        body = json.loads((REPO / c["file"]).read_text())
        assert body["source"] == c["source"] and sorted(body["reduced"]) == sorted(c["reduced"])
        assert (REPO / "portbench" / "drivers" / f"{body['entry']}.py").is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    used = set()
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in cfgs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
        reported = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in SPEC["per_layer"])
    assert used == set(cfgs)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(SPEC)) <= 64 * 1024
