"""The port's tools on the CPU: the multi-process rehearsal
(``tools/torch_rehearsal_multihost.py``), the ratio table
(``tools/torch_ratio_table.py``) and the CI script (``tools/torch_ci.sh``).

* The rehearsal runs in a subprocess at 16 blocks over 2 processes x 2 CPU
  shards; its JSON line is held to the single-process stream, and its
  parent's checks (``_finish``) are run again on the workers' files with a
  byte flipped in a payload or a plaintext, and with overlapping local sets:
  each must raise.
* The ratio table's ``scalar`` and ``best`` columns on 8 KiB stand-ins of
  the 11 corpus names equal ``tools/ratio_table.py::_kernel_sizes`` on the
  same bytes (the JAX kernels in interpret mode), its ``scan`` column the
  JAX scan engine's ``encode_block``; every device stream decodes through
  the oracle. Sizes are exact.
* Neither tool nor ``snappier_tpu_torch.utils.profiling`` loads JAX or the
  JAX package: a subprocess runs each and inspects ``sys.modules``.
* Each tool defaults to the card and raises without one.

The rehearsal at its default size (256 MiB over 4 processes) is the slow
test at the end.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"
REHEARSAL = TOOLS / "torch_rehearsal_multihost.py"
SMALL = (16, 2, 2)  # blocks, processes, shards a process


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rehearsal():
    return _load("torch_rehearsal_multihost")


@pytest.fixture(scope="module")
def ratio():
    return _load("torch_ratio_table")


def _run_tool(args, timeout: float):
    r = subprocess.run([sys.executable, *map(str, args)], capture_output=True, text=True,
                       timeout=timeout, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def worker_files(tmp_path_factory):
    """The workers' files of one fan-out at 16 blocks (the tool's own)."""
    from tests.torch_cases import run_workers

    d = tmp_path_factory.mktemp("rehearsal")
    n_blocks, nprocs, devs = SMALL
    run_workers(d, nprocs, devs, n_blocks)
    return d


def test_rehearsal_line_is_exact(rehearsal):
    from snappier_tpu_torch.parallel import distributed, make_mesh
    from snappier_tpu_torch.runtime import native

    line = _run_tool([REHEARSAL, *SMALL, "--device", "cpu"], timeout=240)
    n_blocks, nprocs, devs = SMALL
    data = rehearsal.worker_module().corpus(n_blocks)
    single, _ = distributed.compress_corpus_sharded(data, mesh=make_mesh(["cpu"] * nprocs * devs),
                                                    kernel="scalar")
    assert line["rehearsal"] == "multi-process ordered assembly"
    assert (line["blocks"], line["nprocs"], line["devices_per_proc"]) == SMALL
    assert line["uncompressed_bytes"] == len(data) == n_blocks * 65536 - 777
    assert line["compressed_bytes"] == len(single)
    assert line["uncompressed_MB"] == len(data) / 1e6
    assert line["compressed_MB"] == len(single) / 1e6
    assert line["bit_exact"] is True and line["decoded_exact"] is True
    assert line["device"] == "cpu" and line["backend"] == "gloo"
    assert line["launches"] == {}  # CPU shards: the plain versions
    assert line["verify_engine"] == ("native" if native.available() else "oracle")
    assert line["attempts"] in (1, 2)
    assert line["compress_wall_s"] > 0 and line["verify_wall_s"] >= 0


def _flip_local_byte(d: pathlib.Path, rank: int, kind: str) -> None:
    meta = json.loads((d / f"meta_{rank}.json").read_text())
    if kind == "payload":
        i = meta["local_blocks"][0]
        at = meta["block_offsets"][i] + meta["block_lengths"][i] // 2
    else:
        i = meta["local_fragments"][0]
        at = meta["fragment_offsets"][i] + meta["fragment_lengths"][i] // 2
    path = d / f"{kind}_{rank}.bin"
    buf = bytearray(path.read_bytes())
    buf[at] ^= 0x20
    path.write_bytes(bytes(buf))


@pytest.mark.parametrize("fault", ["none", "payload", "plain", "overlap"])
def test_rehearsal_finish_catches_a_planted_fault(worker_files, rehearsal, tmp_path, fault):
    """The parent's checks pass on the workers' files and fail on a byte
    flipped inside rank 1's own block or fragment, and on local block sets
    that overlap."""
    d = tmp_path / "files"
    shutil.copytree(worker_files, d)
    if fault in ("payload", "plain"):
        _flip_local_byte(d, 1, fault)
    elif fault == "overlap":
        m0 = json.loads((d / "meta_0.json").read_text())
        m1 = json.loads((d / "meta_1.json").read_text())
        m1["local_blocks"].append(m0["local_blocks"][0])
        (d / "meta_1.json").write_text(json.dumps(m1))
    n_blocks, nprocs, devs = SMALL
    if fault == "none":
        out = rehearsal._finish(d, n_blocks, nprocs, devs, "cpu", 0.0)
        assert out["bit_exact"] and out["decoded_exact"]
        return
    with pytest.raises(AssertionError):
        rehearsal._finish(d, n_blocks, nprocs, devs, "cpu", 0.0)


def test_tools_default_to_the_card(rehearsal, ratio, monkeypatch):
    """Without ``--device cpu`` each tool asks for the card, and without one
    it raises before it starts anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rehearsal.main(["2", "1", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ratio.main(["--size", "1024"])


IMPORT_CHECKS = {
    "rehearsal": """
        spec = importlib.util.spec_from_file_location("t", "tools/torch_rehearsal_multihost.py")
        t = importlib.util.module_from_spec(spec); spec.loader.exec_module(t)
        assert t._finish(FILES, 16, 2, 2, "cpu", 0.0)["bit_exact"]
    """,
    "ratio_table": """
        spec = importlib.util.spec_from_file_location("t", "tools/torch_ratio_table.py")
        t = importlib.util.module_from_spec(spec); spec.loader.exec_module(t)
        assert len(t.table(t.corpus(1024), "cpu")) == 11
    """,
    "profiling": """
        import tempfile
        from snappier_tpu_torch.utils import profiling
        with tempfile.TemporaryDirectory() as d, profiling.device_trace(d, device="cpu"):
            with profiling.Throughput(8, device="cpu"):
                sum(range(8))
        assert profiling.metrics_enabled() in (True, False)
    """,
}


@pytest.mark.parametrize("name", list(IMPORT_CHECKS))
def test_new_tools_load_neither_jax_nor_the_jax_package(worker_files, name):
    body = textwrap.dedent(IMPORT_CHECKS[name]).strip()
    code = (f"import importlib.util, sys\nsys.path.insert(0, '.')\nFILES = {str(worker_files)!r}\n"
            f"{body}\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'snappier_tpu')\n"
            "       or m.startswith(('jax.', 'jaxlib.', 'snappier_tpu.'))]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=180, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]


# --- the ratio table against the JAX package ---------------------------------

SIZE = 8192


@pytest.fixture(scope="module")
def port_table(ratio):
    files = ratio.corpus(SIZE)
    streams = ratio.device_streams(files, "cpu")
    rows = {r["file"]: r for r in ratio.table(files, "cpu", streams=streams)}
    return files, streams, rows


@pytest.fixture(scope="module")
def jax_sizes(port_table):
    """``tools/ratio_table.py``'s kernel columns, and the JAX scan engine's
    stream sizes, on the same stand-ins."""
    import jax.numpy as jnp

    from snappier_tpu.constants import BLOCK_SIZE
    from snappier_tpu.format.varint import write_varint
    from snappier_tpu.ops.encode import encode_block

    files, _, _ = port_table
    sizes = _load("ratio_table")._kernel_sizes(files)
    for name, data in files.items():
        total = len(write_varint(len(data)))
        for start in range(0, max(len(data), 1), BLOCK_SIZE):
            frag = np.frombuffer(data[start : start + BLOCK_SIZE], np.uint8)
            buf = np.zeros(BLOCK_SIZE, np.int32)
            buf[: len(frag)] = frag
            _, n = encode_block(jnp.asarray(buf), jnp.int32(len(frag)))
            total += int(n)
        sizes[name]["scan"] = total
    return sizes


def test_ratio_table_names_and_lengths(ratio, port_table):
    from tests.conftest import CORPUS_FILES

    files, _, rows = port_table
    assert ratio.CORPUS == CORPUS_FILES
    assert sum(ratio.LENGTHS.values()) == 2_906_545
    assert all(len(files[n]) == SIZE and rows[n]["n"] == SIZE for n in CORPUS_FILES)
    # The stand-ins are the corpus test's at this size (the same definition).
    from tests.test_torch_corpus import standin

    assert all(files[n] == standin(n, SIZE) for n in CORPUS_FILES)


@pytest.mark.parametrize("name", ["alice29.txt", "asyoulik.txt", "fireworks.jpeg",
                                  "geo.protodata", "html", "html_x_4", "kppkn.gtb",
                                  "lcet10.txt", "paper-100k.pdf", "plrabn12.txt", "urls.10K"])
def test_ratio_table_columns_match_the_jax_package(port_table, jax_sizes, name):
    from snappier_tpu.format import oracle as jax_oracle
    from snappier_tpu_torch.format import oracle

    files, streams, rows = port_table
    row = rows[name]
    assert {k: row[k] for k in ("scalar", "best", "scan")} == jax_sizes[name]
    assert row["oracle"] == len(jax_oracle.compress(files[name]))
    assert row["best"] <= row["scalar"]
    for col, s in streams[name].items():
        assert len(s) == row[col] and oracle.decompress(s) == files[name], col


# --- the CI script -------------------------------------------------------------

CI = TOOLS / "torch_ci.sh"


def test_ci_script_parses():
    r = subprocess.run(["sh", "-n", str(CI)], capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, r.stderr


def test_ci_script_names_only_paths_that_exist():
    text = CI.read_text()
    code = "\n".join(line for line in text.splitlines() if not line.lstrip().startswith("#"))
    paths = set(re.findall(r"(?:tools|tests)/[\w./]+\.(?:py|sh)|\bchip_smoke\.py", code))
    modules = set(re.findall(r"-m (snappier_tpu_torch[\w.]*)", code))
    assert {"tools/torch_fuzz.py", "tools/torch_rehearsal_multihost.py",
            "tools/torch_ratio_table.py", "chip_smoke.py", "tests/test_torch_cuda.py"} <= paths
    assert modules == {"snappier_tpu_torch.graft_entry"}
    for p in paths:
        assert (ROOT / p).is_file(), p
    for m in modules:
        assert (ROOT / (m.replace(".", "/") + ".py")).is_file(), m
    assert not (ROOT / "benchmarks" / "run_all_torch.py").exists()


@pytest.mark.slow
def test_rehearsal_at_256_mib_on_the_cpu(rehearsal):
    """The default size, 4,096 x 64 KiB over 4 processes x 2 CPU shards."""
    line = _run_tool([REHEARSAL, "--device", "cpu"], timeout=1800)
    assert (line["blocks"], line["nprocs"], line["devices_per_proc"]) == (4096, 4, 2)
    assert line["uncompressed_bytes"] == 4096 * 65536 - 777
    assert line["bit_exact"] and line["decoded_exact"] and line["launches"] == {}
