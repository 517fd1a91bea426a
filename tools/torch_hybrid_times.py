#!/usr/bin/env python3
"""Time the decode-walk ablation (T1-T4), the descriptor-driven decode
(T14-T16, T18 ``decode_v7``), the pipelined decode (T6 ``decode_pipe``, T7
``decode_pipe2``), the chain
probes (T10 ``chain`` and ``chainrec``, T19 ``cliff``, the chase), the
branch probe (T17 ``bprobe`` and its floor), the co-issue probe (T12
``coissue`` and its vector stream alone) and the copy probes (T11 ``vcopy``,
T13 ``iso``) of one or more checkouts on one GPU, beside the production
kernels K1-K4.

    python3 tools/torch_hybrid_times.py ROOT [ROOT ...]
    python3 tools/torch_hybrid_times.py --copy ROOT [ROOT ...]
    python3 tools/torch_hybrid_times.py --probes ROOT [ROOT ...]
    python3 tools/torch_hybrid_times.py --sass ROOT OUT

Each ROOT is a directory that holds a ``snappier_tpu_torch`` package (this
repository's root, or an unpacked ``git archive`` of another commit). For
each ROOT in the order given (list a pair as ``A B B A`` to take turns on
one card), a fresh process imports that package, builds the kernels it
times into ``ROOT/build`` and times them with ``chip_smoke.cuda_ms`` of
this repository (CUDA events, warm-up, best of 3 passes of 5 calls) on the
main path's 512 blocks (64 KiB of bench.py's word mix each, compressed by
K2): K1-K4; ``decode_v5``, ``decode_v6``, ``decode_v7`` and
``decode_v7(unroll2=True)`` with their pre-pass, each walk alone on its
descriptors, ``decode_v5_spec`` on a pre-pass made beforehand and within
the call, the pre-passes alone and each form's peak device memory, at the
codec's row width (68,608 B) and the tight one; ``decode_pipe`` and
``decode_pipe2`` in the eleven forms of ``tests/torch_cases.py``'s
``PIPE_CASES`` (unroll 1-4, ``unc``, ``dma_pipe``, ``emit=False``) at both
widths; ``decode_v2``, ``decode_v4``, ``decode_v3`` and ``decode_variant``
as v1, v1nock and v1nocp at both widths; each form's layout (the pipelined
ones' where the package has ``decode_pipe_layout``, the ablation's where it
has ``decode_variant_layout``) and the ablation kernels' ptxas figures;
``chain``, ``chainrec`` and ``cliff``
in its five modes at 200 walks on block 0 and, where the package has it,
the chase, in ms and ns a walk step; ``vcopy`` 2d and 3d and ``iso`` in its
six modes on block 0's records, in ms and ns a record; ``coissue`` at every
built nvec and, where the package has it, the vector stream alone
(``coissue_vec``), ``bprobe`` at every built nwhen and, where the package has
it, its floor (``bprobe_floor``), in ms and ns an iteration; the probes' ptxas
figures. Every call is first held to its plain version (the walks' rows to
the input; the probes' checksum, records, image or scratch). It prints the
card's name and power limit, then one JSON line per run. It needs a CUDA
card and exits 2 without one.

With ``--copy`` it builds ``csrc/hybrid_probes.cu`` alone and times only
``vcopy`` and ``iso`` (the loop of design trials); with ``--probes``, only
the chain probes, ``bprobe`` with its floor, ``coissue`` with the vector
stream alone, K5 ``match_extension_probe`` on ``chip_smoke.py``'s probe
rows (the wrapper and, where the package has ``launch_probe``, the kernel
alone) and T20 ``bitonic`` on the tool's keys and keys with
ties beside ``torch.sort``. With ``--sass`` it builds ROOT's
``csrc/hybrid_probes.cu``, ``csrc/probe.cu`` and ``csrc/bitonic_probe.cu``
and writes ``cuobjdump -sass`` of their ``cliff_kernel`` (chain's too),
``vcopy_kernel``, ``iso_kernel``, ``bprobe_kernel``, ``bprobe_floor_kernel``,
``coissue_kernel``, ``probe_kernel`` and ``bitonic_cluster_kernel``
instantiations to OUT, then prints, for each, its shared- and local-memory
loads and stores, global loads, shuffles, warp syncs and branches in order:
the step order a reader checks there (a cliff step's next load before its
body; a record's plan shuffled in, and the next batch loaded, before the
previous record's shared loads; no memory access in bprobe's loop; no
branch around a probe walk's loads), its instruction count, the
instructions of its longest loop body (bprobe's: one block of 64
iterations) and its most used instructions.
"""

from __future__ import annotations

import collections
import importlib.util
import inspect
import os
import re
import subprocess
import sys

from torch_crc_times import HERE, in_turns, smoke

SOURCES = ("decode", "encode", "crc32c", "encode_best", "decode_hybrid", "decode_pipe",
           "decode_variants", "hybrid_probes")


def pipe_cases() -> dict:
    """``PIPE_CASES`` of this repository's ``tests/torch_cases.py``: form
    name -> ``decode_pipe2``'s arguments (``"pipe"``: ``decode_pipe``)."""
    spec = importlib.util.spec_from_file_location(
        "torch_cases", os.path.join(HERE, "tests", "torch_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return dict(mod.PIPE_CASES)


def build_some(_build, names) -> None:
    """Build only the sources of the launchers ``names`` (all nvcc runs at
    once) and bind them."""
    with _build._lock:
        srcs = sorted({_build.source_of(n) for n in names})
        started = [(s, *_build._start_build(s)) for s in srcs]
        for src, st, path in started:
            _build._finish_build(src, st, path)
        paths = {s: path for s, _, path in started}
        for n in names:
            _build._launchers[n] = _build.bind(paths[_build.source_of(n)], *_build.SOURCES[n])


def one(root: str) -> dict:
    """The figures of the package at ``root``, timed in this process."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from snappier_tpu_torch.ops.best_match import exact_candidates
    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import crc32c as crc
    from snappier_tpu_torch.ops.cuda import decode_hybrid as dh
    from snappier_tpu_torch.ops.cuda import decode_variants as dv
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    cs = smoke()
    check_root = os.path.abspath(os.path.join(os.path.dirname(dh.__file__), *[".."] * 3))
    cs.check(os.path.samefile(check_root, root), f"imported {check_root}, not {root}")
    build_some(_build, [n for n in _build.SOURCES if _build.source_of(n) in SOURCES])
    B, BLOCK, ms = cs.B, cs.BLOCK, cs.cuda_ms
    html = cs.word_mix()
    reps = -(-B * BLOCK // len(html))
    data = np.frombuffer((html * reps)[: B * BLOCK], np.uint8).reshape(B, BLOCK)
    frags = torch.from_numpy(data.copy()).cuda()
    lengths = torch.full((B,), BLOCK, dtype=torch.int32, device="cuda")
    bodies, body_lens = sc.encode_blocks_bytes(frags, lengths)
    pre = torch.tensor([0x80, 0x80, 0x04], dtype=torch.uint8, device="cuda").expand(B, 3)
    blocks = torch.cat([pre, bodies.to(torch.uint8)], dim=1)
    comp = torch.nn.functional.pad(blocks, (0, (-blocks.shape[1]) % 1024)).contiguous()
    lens = body_lens + 3
    tight = comp[:, : -(-(int(lens.max()) + 8) // 1024) * 1024].contiguous()
    cands = exact_candidates(frags, lengths)
    t = {"k1": ms(lambda: sc.decode_blocks_bytes(comp, lens, BLOCK)),
         "k2": ms(lambda: sc.encode_blocks_bytes(frags, lengths), iters=3),
         "k3": ms(lambda: crc.crc32c_blocks(frags, lengths)),
         "k4": ms(lambda: sc._encode_best(frags, lengths, cands), iters=3)}
    forms = {"v5": dh.decode_v5, "v6": dh.decode_v6, "v7": dh.decode_v7,
             "v7u": lambda c, n, o: dh.decode_v7(c, n, o, unroll2=True)}
    pipes = pipe_cases()
    for width, rows in (("codec", comp), ("tight", tight)):
        for form, fn in forms.items():
            out, out_lens, errs = fn(rows, lens, BLOCK)
            cs.check(bool((errs == 0).all()) and bool((out == frags).all()),
                     f"{form} at the {width} width: rows differ from the input")
            t[f"{form}_{width}"] = ms(lambda: fn(rows, lens, BLOCK))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn(rows, lens, BLOCK)
            torch.cuda.synchronize()
            t[f"{form}_{width}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        for form in ("v5", "v6", "v7", "v7u"):
            p = dh._prepass(rows, form[:2])
            t[f"{form}_{width}_walk"] = ms(lambda: dh._launch(
                form[:2], form == "v7u", rows, p[0], p[1], lens, BLOCK, dh.FORMS[form[:2]][1]))
            if form != "v7u":
                t[f"prepass_{form}_{width}"] = ms(lambda: dh._prepass(rows, form[:2]))
            del p
        # decode_v5_spec on its pre-pass (the kernel where the package has
        # one), made beforehand and within the call.
        spec_of = getattr(dh, "prepass_v5", dh.spec_from_comp)
        words, spec = dh.pack_words(rows), spec_of(rows)
        t[f"v5parts_{width}"] = ms(lambda: dh.decode_v5_spec(words, spec, lens, BLOCK))
        t[f"v5parts_{width}_with_prepass"] = ms(lambda: dh.decode_v5_spec(
            dh.pack_words(rows), spec_of(rows), lens, BLOCK))
        del words, spec
        for name, kw in pipes.items():
            fn = (lambda c, n, o: dv.decode_pipe(c, n, o)) if name == "pipe" else (
                lambda c, n, o, kw=kw: dv.decode_pipe2(c, n, o, **kw))
            out, out_lens, errs = fn(rows, lens, BLOCK)
            cs.check(bool((errs == 0).all()) and bool((out_lens == BLOCK).all()),
                     f"{name} at the {width} width: verdicts")
            if kw.get("emit", True):
                cs.check(bool((out == frags).all()), f"{name} at the {width} width: rows")
            t[f"{name}_{width}"] = ms(lambda: fn(rows, lens, BLOCK))
        for name in cs.VARIANTS:
            fn = cs.variant_call(dv, name)
            out, out_lens, errs = fn(rows, lens, BLOCK)
            cs.check(bool((errs == 0).all()) and bool((out_lens == BLOCK).all()),
                     f"{name} at the {width} width: verdicts")
            if name != "v1nocp":
                cs.check(bool((out == frags).all()), f"{name} at the {width} width: rows")
            t[f"{name}_{width}"] = ms(lambda: fn(rows, lens, BLOCK))
    block = comp[0, : int(lens[0])].cpu().numpy().tobytes()
    per = chain_probe_times(cs, hp, block, t)
    per_record = copy_probe_times(cs, hp, block, t)
    per_iter = coissue_times(cs, hp, t)
    if hasattr(dh, "decode_hybrid_layout"):
        layout = {f: dh.decode_hybrid_layout(comp, BLOCK, f) for f in ("v5", "v6", "v7")}
    else:  # an older package: form 7's query alone
        layout = {"v7": dh.decode_v7_layout(comp, BLOCK)}
    pipe_layout = ({n: dv.decode_pipe_layout(comp, BLOCK, fold=n != "pipe", **kw)
                    for n, kw in pipes.items()} if hasattr(dv, "decode_pipe_layout") else None)
    variant_layout = ({w: {n: dv.decode_variant_layout(r, BLOCK, n) for n in cs.VARIANTS}
                       for w, r in (("codec", comp), ("tight", tight))}
                      if hasattr(dv, "decode_variant_layout") else None)
    return {"root": root, "ms": t, **per, "coissue_ns_per_iter": per_iter,
            "hybrid_layout": layout, "pipe_layout": pipe_layout,
            "variant_layout": variant_layout,
            "variant_ptxas": cs.ptxas_figures(_build.BUILD_LOG.get("decode_variants", ""),
                                              "_kernel"),
            "pipe_ptxas": cs.ptxas_figures(_build.BUILD_LOG.get("decode_pipe", ""),
                                           "decode_pipe_kernel"),
            "hybrid_ptxas": cs.ptxas_figures(_build.BUILD_LOG.get("decode_hybrid", ""),
                                             "_kernel"),
            **probe_ptxas(cs, _build),
            "ns_per_record": per_record,
            "copy_ptxas": [f for k in ("vcopy_kernel", "iso_kernel") for f in cs.ptxas_figures(
                _build.BUILD_LOG.get("hybrid_probes", ""), k)]}


def chain_probe_times(cs, hp, block: bytes, t: dict) -> dict:
    """``chain``, ``chainrec``, the chase and ``cliff``'s five modes at 200
    walks on ``block``'s advances, ``bprobe`` at every built nwhen and its
    floor, each held to its plain version, then timed: ms into ``t``;
    returns ns a walk step and an iteration, the steps and the staged words.
    A package without the chase or the floor is timed without them; one
    whose ``launch_chain`` takes no staged words stages in its kernel."""
    import torch

    ms = cs.cuda_ms
    dev = torch.device("cuda")
    adv, n, ntags = hp.chain_inputs(block)
    adv_h = torch.from_numpy(adv)
    adv_d = adv_h.cuda()
    R = hp.CHAIN_R
    walk = {s: hp._chain_trial(adv.tolist(), n, s, None)[1] for s in (3, 4)}
    steps = sum(walk[3 + (r & 1)] for r in range(R))
    staged = hp.cliff_staged_words(adv_h, n, 3) if hasattr(hp, "cliff_staged_words") else None
    chain_staged = (staged,) if "staged" in inspect.signature(hp.launch_chain).parameters else ()
    for wr, name in ((False, "chain"), (True, "chainrec")):
        got, want = hp.chain(adv_d, n, 3, R, wr), hp.chain_plain(adv_h, n, 3, R, wr)
        cs.check(all(bool((a.cpu() == b).all()) for a, b in zip(got, want)),
                 f"{name} differs from its plain version")
        t[name] = ms(lambda: hp.launch_chain(adv_d, n, 3, R, wr, *chain_staged))
    for m in hp.CLIFF_MODES:
        got, want = hp.cliff(adv_d, n, m, 3, R), hp.cliff_plain(adv_h, n, m, 3, R)
        cs.check(all(bool((a.cpu() == b).all()) for a, b in zip(got, want)),
                 f"cliff {m} differs from its plain version")
        args = (adv_d, n, m, 3, R) + ((staged,) if staged is not None else ())
        t[f"cliff_{m}"] = ms(lambda: hp.launch_cliff(*args))
    if hasattr(hp, "chase"):
        cs.check(hp.chase(adv_d, n, 3, R).cpu().tolist() == hp.chain_plain(adv_h, n, 3, R)[0]
                 .tolist(), "the chase differs from chain's plain version")
        t["chase"] = ms(lambda: hp.launch_chase(adv_d, n, 3, R, staged))
    walks = ("chain", "chainrec", "chase", *(f"cliff_{m}" for m in hp.CLIFF_MODES))
    for nwhen in hp.BPROBE_NWHEN:
        cs.check(all(bool((a.cpu() == b).all()) for a, b in zip(
            hp.bprobe(nwhen, device="cuda"), hp.bprobe_plain(nwhen))),
            f"bprobe {nwhen} differs from its plain version")
        t[f"bprobe_{nwhen}"] = ms(lambda: hp.launch_bprobe(nwhen, 3, dev))
    if hasattr(hp, "bprobe_floor"):
        cs.check(hp.bprobe_floor(3, dev).cpu().tolist() == hp.bprobe_floor_plain(3).tolist(),
                 "bprobe's floor differs from its plain version")
        t["bprobe_floor"] = ms(lambda: hp.launch_bprobe_floor(3, dev))
    iters = [f"bprobe_{w}" for w in hp.BPROBE_NWHEN] + ["bprobe_floor"]
    return {"ns_per_step": {k: t[k] * 1e6 / steps for k in walks if k in t},
            "ns_per_iter": {k: t[k] * 1e6 / hp.BPROBE_ITERS for k in iters if k in t},
            "steps": steps, "tags_block0": ntags, "staged_words": staged}


def coissue_times(cs, hp, t: dict) -> dict:
    """``coissue`` at every built nvec and, where the package has it, the
    vector stream alone (``coissue_vec``), each held to its plain version
    from the fill at 8,192 iterations and from a random tile at 37, then
    timed from the fill: ms into ``t``; returns ns an iteration."""
    import numpy as np
    import torch

    ms = cs.cuda_ms
    fill = torch.full(hp.TILE, hp.FILL, dtype=torch.int32, device="cuda")
    rand = torch.from_numpy(np.random.default_rng(29).integers(
        -(1 << 31), 1 << 31, hp.TILE, dtype=np.int64).astype(np.int32))
    cases = ((None, hp.COISSUE_ITERS), (rand, 37))

    def same(got, want):
        return all(bool((a.cpu() == b).all()) for a, b in zip(got, want))

    for nvec in hp.COISSUE_NVEC:
        for tile, iters in cases:
            cs.check(same(hp.coissue(3, nvec, None if tile is None else tile.cuda(), iters,
                                     device="cuda"), hp.coissue_plain(3, nvec, tile, iters)),
                     f"coissue {nvec} differs from its plain version at {iters} iterations")
        t[f"coissue_{nvec}"] = ms(lambda: hp.launch_coissue(3, nvec, fill))
    if hasattr(hp, "coissue_vec"):
        for tile, iters in cases:
            cs.check(same(hp.coissue_vec(None if tile is None else tile.cuda(), iters,
                                         device="cuda"), hp.coissue_vec_plain(tile, iters)),
                     f"the vector stream alone differs from its plain version at {iters}")
        t["coissue_vec"] = ms(lambda: hp.launch_coissue_vec(fill))
    keys = [f"coissue_{n}" for n in hp.COISSUE_NVEC] + ["coissue_vec"]
    return {k: t[k] * 1e6 / hp.COISSUE_ITERS for k in keys if k in t}


def probe_ptxas(cs, _build) -> dict:
    """ptxas's figures of the walks', bprobe's and coissue's kernels."""
    log = _build.BUILD_LOG.get("hybrid_probes", "")
    return {"cliff_ptxas": cs.ptxas_figures(log, "cliff_kernel"),
            "chain_ptxas": cs.ptxas_figures(log, "chain_kernel"),
            "bprobe_ptxas": cs.ptxas_figures(log, "bprobe_"),
            "coissue_ptxas": cs.ptxas_figures(log, "coissue_kernel")}


def copy_probe_times(cs, hp, block: bytes, t: dict) -> dict:
    """``vcopy`` 2d/3d and ``iso``'s six modes on ``block``'s records, each
    held to its plain version, then timed: ms into ``t``; returns ns a
    record."""
    import numpy as np
    import torch

    ms = cs.cuda_ms
    img_h = torch.from_numpy((np.arange(hp.IMAGE_WORDS, dtype=np.int64) * 40503).astype(np.int32))
    img_d = img_h.cuda()
    recs = hp.tags_from_block(block)[1]
    per_record = {}
    for probe, rec, modes in (("vcopy", hp.vcopy_records(recs), hp.MODES),
                              ("iso", hp.iso_records(recs), hp.ISO_MODES)):
        rec_h = torch.from_numpy(rec)
        rec_d = rec_h.cuda()
        nrec = int(rec[hp.COUNT_AT])
        count = nrec if probe == "vcopy" else hp.ISO_PASSES * nrec - hp.ISO_PASSES // 2
        call, launch, plain = ((hp.vcopy, hp.launch_vcopy, hp.vcopy_plain) if probe == "vcopy"
                               else (hp.iso, hp.launch_iso, hp.iso_plain))
        for m in modes:
            got, want = call(rec_d, img_d, m), plain(rec_h, img_h, m)
            cs.check(all(bool((a.cpu() == b).all()) for a, b in zip(got, want)),
                     f"{probe} {m} differs from its plain version")
            t[f"{probe}_{m}"] = ms(lambda: launch(rec_d, img_d, m))
            per_record[f"{probe}_{m}"] = t[f"{probe}_{m}"] * 1e6 / count
        per_record[f"{probe}_records"] = count
    return per_record


def one_copy(root: str) -> dict:
    """The copy probes of the package at ``root`` alone, on the main path's
    block 0 (the same as :func:`one`'s)."""
    sys.path.insert(0, root)
    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    cs, block = block0(root, ["vcopy", "iso"])
    t = {}
    per_record = copy_probe_times(cs, hp, block, t)
    return {"root": root, "ms": t, "ns_per_record": per_record,
            "copy_ptxas": [f for k in ("vcopy_kernel", "iso_kernel") for f in cs.ptxas_figures(
                _build.BUILD_LOG.get("hybrid_probes", ""), k)]}


def probe_sort_times(cs, sc, hp, t: dict) -> dict:
    """K5 on ``chip_smoke``'s probe rows (the golden vectors and 300 planted
    matches in rows of 64 KiB): the wrapper and, where the package has
    ``launch_probe``, the kernel alone; T20 on the
    tool's keys and on keys with ties, each beside ``torch.sort`` of the
    same keys. Each held to the expected lengths or the plain version, then
    timed by ``cuda_ms`` and replayed from a CUDA graph (``_graph``, the
    device time without the host's): ms into ``t``; returns the kernels'
    ptxas figures."""
    import numpy as np
    import torch

    from snappier_tpu_torch.ops.cuda import _build

    ms = cs.cuda_ms
    bufs, ats, cands, ns, expected = cs.probe_batch()
    dev = [torch.from_numpy(x).cuda() for x in (bufs, ats, cands, ns)]
    cs.check(sc.match_extension_probe(*dev).cpu().tolist() == expected.tolist(),
             "probe differs from the golden and planted lengths")
    t["probe"] = ms(lambda: sc.match_extension_probe(*dev))
    t["probe_graph"] = cs.graph_ms(lambda: sc.match_extension_probe(*dev))
    if hasattr(sc, "launch_probe"):
        cs.check(sc.launch_probe(*dev).cpu().tolist() == expected.tolist(),
                 "probe's kernel differs from the expected lengths")
        t["probe_launch"] = ms(lambda: sc.launch_probe(*dev))
        t["probe_launch_graph"] = cs.graph_ms(lambda: sc.launch_probe(*dev))
    sets = {"keys": np.random.default_rng(5).integers(-(2**31), 2**31 - 1, hp.SORT_N,
                                                      np.int64).astype(np.int32),
            "ties": np.random.default_rng(9).integers(-4, 4, hp.SORT_N).astype(np.int32)}
    for name, x in sets.items():
        xd = torch.from_numpy(x).cuda()
        got, want = hp.bitonic(xd), hp.bitonic_plain(torch.from_numpy(x))
        cs.check(all(bool((a.cpu() == b).all()) for a, b in zip(got, want)),
                 f"bitonic differs from its plain version on the {name}")
        t[f"bitonic_{name}"] = ms(lambda: hp.launch_bitonic(xd))
        t[f"bitonic_{name}_graph"] = cs.graph_ms(lambda: hp.launch_bitonic(xd))
        t[f"sort_{name}"] = ms(lambda: torch.sort(xd, stable=True))
        t[f"sort_{name}_graph"] = cs.graph_ms(lambda: torch.sort(xd, stable=True))
    log = _build.BUILD_LOG
    return {"probe_ptxas": cs.ptxas_figures(log.get("probe", ""), "probe_kernel"),
            "bitonic_ptxas": cs.ptxas_figures(log.get("bitonic_probe", ""), "bitonic")}


def one_probes(root: str) -> dict:
    """The chain probes, bprobe with its floor, coissue with the vector
    stream alone, K5 and T20 of the package at ``root``, on the main path's
    block 0 (the same as :func:`one`'s) and the probe path's rows."""
    sys.path.insert(0, root)
    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    cs, block = block0(root, ["chain", "cliff", "chase", "bprobe", "coissue", "probe",
                              "bitonic"])
    t = {}
    per = chain_probe_times(cs, hp, block, t)
    per_iter = coissue_times(cs, hp, t)
    extra = probe_sort_times(cs, sc, hp, t)
    return {"root": root, "ms": t, **per, "coissue_ns_per_iter": per_iter,
            **probe_ptxas(cs, _build), **extra}


def block0(root: str, launchers) -> tuple:
    """This repository's ``chip_smoke`` module and the main path's block 0
    (K2's block of the word mix's first 64 KiB), the package at ``root``
    checked as the one imported and ``launchers`` built with the encoder."""
    import numpy as np
    import torch

    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    cs = smoke()
    check_root = os.path.abspath(os.path.join(os.path.dirname(sc.__file__), *[".."] * 3))
    cs.check(os.path.samefile(check_root, root), f"imported {check_root}, not {root}")
    build_some(_build, ["encode", *(n for n in launchers if n in _build.SOURCES)])
    html = cs.word_mix()
    data = np.frombuffer((html * (cs.BLOCK // len(html) + 1))[: cs.BLOCK], np.uint8)
    frags = torch.from_numpy(data.copy()).reshape(1, -1).cuda()
    bodies, body_lens = sc.encode_blocks_bytes(
        frags, torch.full((1,), cs.BLOCK, dtype=torch.int32, device="cuda"))
    return cs, bytes([0x80, 0x80, 0x04]) + bodies[0, : int(body_lens[0])].cpu().numpy().tobytes()


SASS_KERNELS = ("cliff_kernel", "vcopy_kernel", "iso_kernel", "bprobe_kernel",
                "bprobe_floor_kernel", "coissue_kernel", "probe_kernel", "bitonic_cluster_kernel")


def sass(root: str, out: str) -> int:
    """cuobjdump -sass of ROOT's cliff (chain's too), vcopy, iso, bprobe,
    coissue, probe (K5) and bitonic (T20) kernels into OUT, and each
    kernel's shared- and local-memory loads and stores, global loads,
    shuffles, warp syncs and branches in order, its instruction count, the
    instructions of its longest loop body (from a backward branch's target
    to the branch) and its most used instructions."""
    sys.path.insert(0, root)
    from snappier_tpu_torch.ops.cuda import _build

    build_some(_build, ["cliff", "probe", "bitonic"])
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = "".join(subprocess.run([cuobjdump, "-sass", str(_build._lib_path(stem))],
                                  capture_output=True, text=True, check=True, timeout=300).stdout
                   for stem in ("hybrid_probes", "probe", "bitonic_probe"))
    funcs = re.split(r"\n\s*Function : ", text)
    keep = [f for f in funcs if f.startswith("_Z") and any(
        k in f.split("\n", 1)[0] for k in SASS_KERNELS)]
    with open(out, "w") as fh:
        fh.write("\n".join("Function : " + f for f in keep))
    for f in keep:
        name = f.split("\n", 1)[0].strip()
        ops = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)"
                         r"([^;]*);", f)
        seq = [f"{addr}:{(pred or '').strip()}{op}" for addr, pred, op, _ in ops
               if op.split(".")[0] in ("LDS", "STS", "LDL", "STL", "LDG", "SHFL", "WARPSYNC",
                                       "BRA", "BSYNC", "BSSY", "EXIT")]
        loops = [(int(addr, 16) - int(m.group(1), 16)) // 16 + 1 for addr, _, op, rest in ops
                 if op.startswith("BRA") and (m := re.search(r"0x([0-9a-f]+)", rest))
                 and int(m.group(1), 16) < int(addr, 16)]
        by_op = collections.Counter(op.split(".")[0] for _, _, op, _ in ops)
        print(name, " ".join(seq), f"| {len(ops)} instructions; longest loop body "
              f"{max(loops, default=0)} instructions; most used {by_op.most_common(6)}",
              flush=True)
    return 0


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--sass":
        return sass(os.path.abspath(argv[1]), argv[2])
    if argv and argv[0] == "--copy":
        return in_turns(__file__, one_copy, argv[1:], flags=("--copy",))
    if argv and argv[0] == "--probes":
        return in_turns(__file__, one_probes, argv[1:], flags=("--probes",))
    return in_turns(__file__, one, argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
