#!/usr/bin/env python3
"""Time the encode ablation (T5 ``encode_variant``, T8 ``encode_r4``) of one
or more checkouts on one GPU, beside the encode kernel (K2) and the
encoder's budget (T9 ``encode_stats``).

    python3 tools/torch_encode_times.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``snappier_tpu_torch`` package (this
repository's root, or an unpacked ``git archive`` of another commit). For
each ROOT in the order given (list a pair as ``A B B A`` to take turns on
one card), a fresh process imports that package, builds its kernels into
``ROOT/build`` and times, on 512 fragments of 64 KiB of bench.py's word mix,
K2, every call of ``chip_smoke.py`` phase 8 (``chip_smoke.encode_cases``:
the 16 named tuples, the empty one, a run-time mask and the 16 names) and
T9, each with ``chip_smoke.cuda_ms`` of this repository (CUDA events,
warm-up, best of 3 passes of 3 calls). Before it is timed, each variant that
gives the encode kernel's bytes is held to them, every other emitting
variant's bodies are decoded by the decode kernel back to the input, and
T9's counts of 8 fragments are held to its plain walk. It prints the card's
name and power limit, then one JSON line per run with the times in ms, the
layouts where the package has the layout queries, and ptxas's figures for
the ablation kernels and T9's. It needs a CUDA card and exits 2
without one.
"""

from __future__ import annotations

import os
import sys

from torch_crc_times import in_turns, smoke


def one(root: str) -> dict:
    """The encode ablation of the package at ``root``, timed in this process."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import encode_variants as ev
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    cs = smoke()
    check_root = os.path.abspath(os.path.join(os.path.dirname(ev.__file__), *[".."] * 3))
    cs.check(os.path.samefile(check_root, root), f"imported {check_root}, not {root}")
    html = cs.word_mix()
    reps = -(-cs.B * cs.BLOCK // len(html))
    data = np.frombuffer((html * reps)[: cs.B * cs.BLOCK], np.uint8).reshape(cs.B, cs.BLOCK)
    frags = torch.from_numpy(data.copy()).cuda()
    lengths = torch.full((cs.B,), cs.BLOCK, dtype=torch.int32, device="cuda")
    _build.build_all()
    wrappers = {"encode_variant": ev.encode_variant, "encode_r4": ev.encode_r4}
    k2_b, k2_l = sc.encode_blocks_bytes(frags, lengths)
    pre = torch.tensor([0x80, 0x80, 0x04], dtype=torch.uint8, device="cuda").expand(cs.B, 3)
    keep = torch.arange(k2_b.shape[1], device="cuda")[None, :] < k2_l[:, None]
    ms = {"k2": cs.cuda_ms(lambda: sc.encode_blocks_bytes(frags, lengths), iters=3)}
    for counter, name, arg in cs.encode_cases(ev):
        fn = wrappers[counter]
        bodies, body_lens = fn(frags, lengths, arg)
        if name in ev.R4_PRODUCTION_BYTES:
            cs.check(bool((body_lens == k2_l).all()) and bool(
                ((bodies == k2_b[:, : bodies.shape[1]]) | ~keep[:, : bodies.shape[1]]).all()),
                f"{name}: bytes differ from the encode kernel's")
        elif ("noemit" not in arg) if counter == "encode_variant" else name not in ev.R4_NO_BYTES:
            out, out_lens, errs = sc.decode_blocks_bytes(torch.cat([pre, bodies], dim=1),
                                                         body_lens + 3, cs.BLOCK)
            cs.check(bool((errs == 0).all()) and bool((out == frags).all()),
                     f"{name}: does not decode to the input")
        ms[name] = cs.cuda_ms(lambda: fn(frags, lengths, arg), iters=3)
    picks = torch.arange(0, cs.B, cs.B // 8, device="cuda")
    stats = ev.encode_stats(frags, lengths)
    want = ev.encode_stats_plain(frags[picks].cpu(), lengths[picks].cpu())
    cs.check(bool((stats[picks].cpu() == want).all()), "encode_stats differs from its plain walk")
    ms["encode_stats"] = cs.cuda_ms(lambda: ev.encode_stats(frags, lengths), iters=3)
    layouts = None
    if hasattr(ev, "encode_r4_layout"):
        layouts = {"e3": ev.encode_variant_layout(frags, ev.VARIANT_FLAGS["e3"]),
                   "encpre": ev.encode_r4_layout(frags, "encpre")}
    if hasattr(ev, "encode_stats_layout"):
        layouts = {**(layouts or {}), "encode_stats": ev.encode_stats_layout(frags)}
    ptxas = {src: cs.ptxas_figures(_build.BUILD_LOG.get(src, ""), "_kernel")
             for src in ("encode_variants", "encode_r4", "encode_stats")}
    return {"root": root, "ms": ms, "layouts": layouts, "encode_stats_ptxas": ptxas["encode_stats"],
            "ptxas_max_registers": {k: max((f.get("registers", 0) for f in v), default=None)
                                    for k, v in ptxas.items()},
            "ptxas_stack_or_spill": sum(f.get(k, 0) for v in ptxas.values() for f in v
                                        for k in ("stack", "spill_stores", "spill_loads"))}


def main(argv) -> int:
    return in_turns(__file__, one, argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
