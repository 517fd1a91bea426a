"""The port's fuzz campaigns at the JAX tools' volumes, on the CPU.

The twin of ``tests/test_fuzz_campaigns.py``: ``tools/torch_fuzz.py``'s
campaigns at the volumes that file runs ``tools/fuzz_host.py`` at (and
``tools/fuzz_tpu.py``'s record for the round-trip and corrupt campaigns),
through the kernels' plain versions. Marked ``slow``; the card runs the
device campaigns at their defaults (``tests/test_torch_cuda.py -k fuzz``).
"""

from __future__ import annotations

import importlib.util
import pathlib

import pytest

_TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


@pytest.fixture(scope="module")
def fuzz():
    spec = importlib.util.spec_from_file_location("torch_fuzz", _TOOLS / "torch_fuzz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_native_fuzz_reference_volume(fuzz):
    """20,000 C++ round trips with oracle cross-decodes."""
    assert fuzz.run_native(20000, 301)["rows"] in (0, 20000)


@pytest.mark.slow
def test_stream_fuzz(fuzz):
    """2,000 framed round trips and mutant agreement between the C++ and
    Python chunk machines."""
    assert fuzz.run_stream(2000, 301)["rows"] in (0, 2000)


@pytest.mark.slow
def test_facade_fuzz(fuzz):
    """2,000 iterations through the facade on each device engine, a mutant
    of each stream judged by the oracle."""
    r = fuzz.run_facade(2000, 301, "cpu")
    assert {k: v["rows"] for k, v in r["by_kernel"].items()} == {"scalar": 2000, "scan": 2000}


@pytest.mark.slow
def test_device_stream_fuzz(fuzz):
    """Flush-heavy framed writes through the device engine's plain versions,
    with framed mutants judged by three engines."""
    assert fuzz.run_device_stream(20, 301, "cpu")["crc_caught"] > 0


@pytest.mark.slow
def test_scalar_kernel_fragment_fuzz(fuzz):
    """The {1, 8, 64} KiB fragment ladder through the encoders and back."""
    assert fuzz.run_scalar(256, 301, "cpu")["rows"] == 256


@pytest.mark.slow
def test_roundtrip_fuzz(fuzz):
    """fuzz_tpu.py's record: 768 round-trip blocks on three paths."""
    assert fuzz.run_roundtrip(768, 301, "cpu")["rows"] == 768


@pytest.mark.slow
def test_corrupt_fuzz(fuzz):
    """Mutants through the decoder beside valid rows, both row widths."""
    r = fuzz.run_corrupt(2048, 301, "cpu")
    assert r["mutants"] == 2048 and r["verdicts"]["accepted"] and r["verdicts"]["rejected"]
