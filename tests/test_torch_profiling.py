"""The port's profiling helpers (``snappier_tpu_torch/utils/profiling.py``)
on the CPU: the twin of ``tests/test_utils.py``'s ``Throughput``,
``device_trace`` and metrics tests.

``Throughput`` and ``device_trace`` take the device as the port's codec
does: the card by default, which raises without one, or ``device="cpu"``
(the host clock alone; a trace of host activity). On the card,
``tests/test_torch_cuda.py -k device_trace`` holds the trace to the kernels'
names.
"""

from __future__ import annotations

import json

import pytest
import torch

import snappier_tpu_torch.utils.profiling as prof
from snappier_tpu.utils import profiling as jax_prof


def test_throughput_on_a_cpu_region():
    with prof.Throughput(1_000_000, device="cpu") as t:
        sum(range(1000))
    assert t.seconds > 0 and t.gbps > 0
    assert t.gbps == pytest.approx(1_000_000 / t.seconds / 1e9)
    assert t.device == torch.device("cpu")


def test_device_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    with prof.device_trace(tmp_path / "traces", device="cpu") as p:
        (torch.arange(64) * 3).sum()
    files = sorted((tmp_path / "traces").glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mul" in str(e.get("name")) for e in events)
    assert any("aten::mul" in e.key for e in p.key_averages())
    with prof.device_trace(tmp_path / "traces", device="cpu"):
        pass
    assert len(list((tmp_path / "traces").glob("trace-*.json"))) == 2  # a new file a trace


@pytest.mark.parametrize("helper", ["device_trace", "Throughput"])
def test_default_device_raises_without_a_card(monkeypatch, tmp_path, helper):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if helper == "device_trace":
            with prof.device_trace(tmp_path):
                pass
        else:
            prof.Throughput(1)
    assert not list(tmp_path.glob("trace-*.json"))


@pytest.mark.parametrize("enabled", [False, True])
def test_metrics_enabled_follows_the_flag(monkeypatch, enabled):
    monkeypatch.setattr(prof, "_ENABLED", enabled)
    monkeypatch.setattr(jax_prof, "_ENABLED", enabled)
    assert prof.metrics_enabled() is enabled is jax_prof.metrics_enabled()


def test_public_names_match_the_jax_module():
    public = {n for n in vars(jax_prof) if not n.startswith("_") and callable(vars(jax_prof)[n])}
    assert public == {"device_trace", "Throughput", "metrics_enabled", "timed_call",
                      "metrics_snapshot", "metrics_reset"}
    assert all(callable(getattr(prof, n, None)) for n in public)
