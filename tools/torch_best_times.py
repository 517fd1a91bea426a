#!/usr/bin/env python3
"""Time K4, the level="best" encode walk (``scalar_codec._encode_best``), of
one or more checkouts on one GPU.

    python3 tools/torch_best_times.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``snappier_tpu_torch`` package (this
repository's root, or an unpacked ``git archive`` of another commit). For
each ROOT in the order given (list a pair as ``A B B A`` to take turns on
one card), a fresh process imports that package, builds its candidate
search and K4 into ``ROOT/build`` and times ``_encode_best`` with
``chip_smoke.cuda_ms`` of this repository (CUDA events, warm-up, best of 3
passes of 5 calls) on two inputs, each with its exact candidates: 512 rows
of 64 KiB of the benchmark's corpus traffic (``portbench/traffic/corpus.json``
at seed 1: the facade's rows of a 32 MiB object), and ``chip_smoke.py``'s
main-path rows (512 blocks of bench.py's word mix). Each call's output is
first held to the plain version on every 16th row. It also gives K4's
layout and, where the package's ``_encode_best`` takes ``stats``, the counts
of one call on each input. It prints the card's name and power limit, then
one JSON line per run. It needs a CUDA card and exits 2 without one.
"""

from __future__ import annotations

import inspect
import os
import sys

from torch_crc_times import HERE, in_turns, smoke


def corpus_rows(rows: int, F: int):
    """The first rows * F bytes of the corpus traffic at seed 1, uint8 [rows, F]."""
    sys.path.insert(0, HERE)
    from portbench import generator

    mix = generator.load_mix("corpus")
    per = sum(f["length"] for f in mix["files"])
    made = generator.files(mix, 1, -(-rows * F // per), "cpu")
    return generator.concatenated(made, mix)[: rows * F].view(rows, F).contiguous()


def one(root: str) -> dict:
    """K4 of the package at ``root``, timed in this process."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from snappier_tpu_torch.ops.best_match import exact_candidates
    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    cs = smoke()
    got_root = os.path.abspath(os.path.join(os.path.dirname(sc.__file__), *[".."] * 3))
    cs.check(os.path.samefile(got_root, root), f"imported {got_root}, not {root}")
    if hasattr(_build, "build"):
        _build.build(["encode_best", "best_candidates"])
    B, BLOCK = cs.B, cs.BLOCK
    html = cs.word_mix()
    reps = -(-B * BLOCK // len(html))
    inputs = {
        "corpus": corpus_rows(B, BLOCK),
        "word_mix": torch.from_numpy(
            np.frombuffer((html * reps)[: B * BLOCK], np.uint8).reshape(B, BLOCK).copy()),
    }
    with_stats = "stats" in inspect.signature(sc._encode_best).parameters
    out = {"root": root, "layout": sc.best_layout(inputs["corpus"].cuda())}
    for name, rows in inputs.items():
        frags = rows.cuda()
        lengths = torch.full((B,), BLOCK, dtype=torch.int32, device="cuda")
        cands = exact_candidates(frags, lengths)
        bodies, body_lens = sc._encode_best(frags, lengths, cands)
        pick = torch.arange(0, B, 16)
        want_b, want_l = sc.encode_best_plain(rows[pick], lengths[pick].cpu(),
                                              cands[pick].cpu(), 32)
        got_b, got_l = bodies[pick.cuda()].cpu(), body_lens[pick.cuda()].cpu()
        cs.check(bool((got_l == want_l).all()), f"{name}: K4 lengths differ from the plain's")
        for i, n in enumerate(want_l.tolist()):
            cs.check(bool((got_b[i, :n] == want_b[i, :n]).all()), f"{name}: row {16 * i} differs")
        res = {"ms": cs.cuda_ms(lambda: sc._encode_best(frags, lengths, cands)),
               "body_bytes": int(body_lens.sum())}
        if with_stats:
            stats = torch.zeros(2, dtype=torch.int32, device="cuda")
            sc._encode_best(frags, lengths, cands, stats=stats)
            res["finished"], res["rewalked"] = stats.tolist()
        out[name] = res
    return out


def main(argv) -> int:
    return in_turns(__file__, one, argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
