#!/usr/bin/env python3
"""Time the CRC32C kernel (K3) of one or more checkouts on one GPU.

    python3 tools/torch_crc_times.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``snappier_tpu_torch`` package (this
repository's root, or an unpacked ``git archive`` of another commit). For
each ROOT in the order given (list a pair as ``A B B A`` to take turns on
one card), a fresh process imports that package, builds its kernels into
``ROOT/build`` and times its ``crc32c_blocks`` three ways with
``chip_smoke.k3_times`` of this repository (the wrapper, the bare launcher,
a CUDA graph of launches, warm and cold), on 512 and on 256 rows of 64 KiB
of bench.py's word mix, each graph's output held to the plain version. It
prints the card's name and power limit, then one JSON line per run, with
ptxas's figures for the kernel. It needs a CUDA card and exits 2 without
one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(root: str) -> dict:
    """K3 of the package at ``root``, timed in this process."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import crc32c as crc

    cs = smoke()
    check_root = os.path.abspath(os.path.join(os.path.dirname(crc.__file__), *[".."] * 3))
    cs.check(os.path.samefile(check_root, root), f"imported {check_root}, not {root}")
    html = cs.word_mix()
    reps = -(-cs.B * cs.BLOCK // len(html))
    data = np.frombuffer((html * reps)[: cs.B * cs.BLOCK], np.uint8).reshape(cs.B, cs.BLOCK)
    frags = torch.from_numpy(data.copy()).cuda()
    lengths = torch.full((cs.B,), cs.BLOCK, dtype=torch.int32, device="cuda")
    _build.launcher("crc32c")
    return {
        "root": root,
        "512": cs.k3_times(torch, crc, _build, frags, lengths),
        "256": cs.k3_times(torch, crc, _build, frags[:256], lengths[:256]),
        "ptxas": cs.ptxas_figures(_build.BUILD_LOG.get("crc32c", ""), "crc32c_kernel"),
    }


def in_turns(script: str, one_fn, argv, flags=()) -> int:
    """The command line of a tool that times checkouts in turns: with
    ``--one ROOT`` it prints ``one_fn(ROOT)`` as JSON; with ROOT ... it
    prints the card's name and power limit, then runs ``script *flags --one
    ROOT`` in a fresh process for each ROOT in order and prints its JSON
    line."""
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps(one_fn(os.path.abspath(argv[1]))))
        return 0
    import torch

    name = os.path.basename(script)
    if not torch.cuda.is_available() or not argv:
        print(f"usage: {name} ROOT [ROOT ...] (needs a CUDA card)", file=sys.stderr)
        return 2
    print(smoke().card_line())
    for root in argv:
        r = subprocess.run([sys.executable, os.path.abspath(script), *flags, "--one", root],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return 1
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


def main(argv) -> int:
    return in_turns(__file__, one, argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
