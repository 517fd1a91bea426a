#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``snappier_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` (the kernels are built from ``snappier_tpu_torch/csrc`` into
``build/`` at first use), ``make`` and a C++ compiler (the native host
runtime in ``native/``) and no network. Phases, each of which raises on
failure:

0. liveness: ``device_alive`` compiles the salted one-line kernel of
   ``csrc/watch.cu`` afresh, launches it and checks it against its plain
   version, before anything else is built; then it is timed beside
   ``torch.add`` per call (host included), as a bare launcher, by each
   wrapper's host time, and replayed from a CUDA graph;
1. the card's name and power limit (``nvidia-smi``); build the kernels;
2. each kernel against its plain version on the same inputs, with edge and
   corrupt rows (exact equality: the kernels compute bytes, bits and match
   lengths), the encode kernel also on its rows 1 byte into a larger buffer
   and on rows of 65,535 bytes (its byte loader); the decode kernel also on
   its rows 1 byte into a buffer and on the batch walk's edge rows
   (``torch_cases.batch_streams``) at out_cap 8,190, both loaders, the last
   row ending at its buffer's end; the best encode kernel also 1 byte into
   a buffer; the CRC32C kernel on the edge lengths of its split
   (``torch_cases.crc_rows``) at 64 KiB, 1 byte into a buffer, at widths
   65,535 and 4,097 and as 2,048 rows;
   the probe path: the FindMatchLength golden
   vectors and 300 rows of 64 KiB with planted matches through
   ``match_extension_probe`` (one launch, the clamps in the kernel), and
   the kernel alone (``launch_probe``);
3. the batched codec at full size: ``SnappyCodec(with_crc=True)`` compresses
   512 blocks of 64 KiB of markup-like text (bench.py's seeded word mix),
   ``decompress_batch`` decodes them back, and the result is held against
   the input, the host CRC32C and the host oracle decoder; every kernel of
   the path must have launched; ``frame_batch`` and ``roundtrip_step`` run
   once;
4. timings with CUDA events (warm-up, best of 3 passes); the CRC32C kernel
   three ways (:func:`k3_times`: the wrapper, the bare launcher, replayed
   from a CUDA graph) and its layout; the encode and decode kernels' layouts
   (blocks per SM, shared bytes per block, threads, loader; the decode
   kernel must hold three blocks an SM at out_cap 65,536) and ptxas's
   registers, stack and spills for the encode, decode, best encode and
   CRC32C kernels (any stack or spill fails);
5. the public facade at full size on the same 32 MiB: ``compress`` at both
   levels and ``decompress`` of each (multi-block, through the native
   prescan and the decode kernel), round trips checked exactly, best no
   larger than fast, the best stream decoded independently by the native
   engine; ``*_into``, ``*_to_memory`` and a corrupt input on 1 MiB; then
   host wall-clock per facade call and CUDA-event times of the candidate
   search and the new kernels; the decode kernel, T4 ``v1`` (the decode
   kernel's batched walk, every round of a step stored whole) and the best
   encode kernel on the 512 blocks in turns (each twice, the second time in
   reverse order), with the best encode kernel's layout; the candidate
   search's kernel (``best_candidates``) at the main path's shape (the 512
   blocks, the default ladder): its cluster layout and ptxas figures
   (printed), one launch a call, its candidates against its plain
   version (the tensor chain) on the card and, for four rows, on the CPU, no
   row sorted a width whole, its time with CUDA events beside the tensor
   chain's on the card (``library_ms``: the port no longer calls it);
6. the framing format and the stream layers at full size: 128 MiB (2,048
   chunks, every eighth of random bytes, so both chunk types occur)
   through ``stream_compress`` and ``stream_decompress`` on the card in 8
   pipelined sub-batches, round trip exact, with the host CRC functions
   forbidden where the kernel must compute the CRC; the stream decoded by
   the native engine and (a 4 MiB prefix) by the framing oracle; a
   native-made stream decoded on the card; ``SnappyWriter`` /
   ``SnappyReader`` on 32 MiB at 8 KiB and 1 MiB transfers; the async
   twins; ``compress_iter`` / ``decompress_iter``; corrupt probes; the
   decode-side function (decode, CRC32C of the decoded rows, packing) on
   the card against the CPU; then timings: host wall-clock per call with
   the pipeline as it is and with every sub-batch fetched before the next
   is staged, and the stages of a sub-batch each timed alone, the CRC32C
   kernel three ways on a sub-batch and on its decoded rows;
7. the decode-walk ablation and the scan engine at full size. Ablation: each
   of the six variants (``decode_v2``, ``decode_v4``, ``decode_v3``,
   ``decode_variant`` as v1, v1nock, v1nocp) against its plain version on
   phase 2's rows and on more edge and corrupt rows, word rows and the same
   rows 1 byte into a buffer (the byte loader), then the 512 blocks that the
   encode kernel made in phase 3 through the production decode kernel and
   every variant, each full variant's rows equal to the input and to the
   production kernel's; each form's layout (three blocks of two warps an SM
   at out_cap 65,536) and ptxas figures (any stack or spill fails); timings
   of each beside the production kernel, at the codec's row width and at the
   tight one. Scan:
   ``SnappyCodec(kernel="scan", with_crc=True)`` on the same 512 blocks,
   round trip exact, with none of the CUDA kernels launched; its bodies
   decoded by the decode kernel and the oracle, the encode kernel's bodies
   by the scan decoder, its CRCs against the CRC32C kernel and the host,
   its total size no larger than the greedy encoder's; ``frame_batch``;
   corrupt rows give the separate error bits; the facade and the streams in
   a subprocess with ``SNAPPIER_KERNEL=scan``; timings and peak memory;
8. block-axis sharding and the encode-walk and pipelined-decode ablation at
   full size. Sharded: ``sharded_roundtrip_step`` on the 512 blocks over a
   mesh of 4 shards on the card (the card listed four times, a stream each)
   with both engines, the bodies, lengths and offsets held against the
   unsharded codec's; ``compress_corpus_sharded`` and
   ``decompress_corpus_sharded`` on 256 MiB (scalar kernels) and 32 MiB
   (scan), each stream also decoded by the native engine; a corrupt stream;
   two processes of ``tools/torch_dist_worker.py`` on the card joined over
   loopback, their union exact; one process on an NCCL group where the
   build has NCCL; ``graft_entry.dryrun_multichip(4)``; timings of the
   4-shard step beside the unsharded one and of the length gather and the
   assembly. Encode ablation: ``encode_variant`` under every named flag
   tuple, ``encode_r4`` under every name, ``decode_pipe`` and
   ``decode_pipe2`` in every form, each against its plain version on edge
   rows (also 1 byte into a buffer: the byte loader; the decoders' rows hold
   literals of no bytes, which ``decode_pipe2`` takes) and on rows of the
   full 65,536 bytes, ``decode_pipe``'s verdicts equal to the production
   decoder's; the layouts (the encoders' K2's: at least 3 blocks an SM at
   15 hash bits, 4 at 14; the pipelined decoders' K1's: 3 blocks of 64
   threads at out_cap 65,536 in every form) and ptxas figures (any stack or
   spill fails); then on the 512 blocks: a variant that gives the production
   encoder's bytes held to them, any other decoded by the decode kernel to
   the input, the decoders' rows equal to the production kernel's; timings
   of each beside the production kernels;
9. the descriptor-driven decode at full size: ``decode_v5``,
   ``decode_v5_spec`` (on a pre-pass computed beforehand), ``decode_v6`` and
   ``decode_v7`` (with and without ``unroll2``), each against its plain
   version on phase 2's rows, edge, corrupt and step-back rows and 9 of the
   main path's blocks of 65,536 bytes, their pre-passes on the card
   (``prepass_v5``, ``prepass_v6``, ``prepass_v7``: kernels) against the
   CPU's tensor code, their verdicts against the production kernel's; the
   pre-passes and the walks also on rows that are no word rows (3 bytes
   narrower, 1 byte into a buffer); then the 512 blocks through the
   production kernel and every form at the codec's row width and the tight
   one, each row equal to the input; each form's layout (three blocks an SM
   at out_cap 65,536) and ptxas figures (any stack or spill fails); timings
   beside the production kernel (ns per tag), the pre-passes alone (kernel
   and tensor code), each walk alone and the peak device memory of one
   call;
10. the micro-probes: ``encode_stats`` (the encoder's budget) against its
   plain walk on rows of 4 KiB and 9 of the main path's fragments, its
   layout (K2's: three blocks of one warp an SM at 65,536 B, two waves of
   the 512 fragments), and ``chain`` / ``chainrec``, ``vcopy`` (2d, 3d),
   ``coissue`` (nvec 0, 1, 2, 8) and its vector stream alone
   (``coissue_vec``; from interpret mode's fill and from a random tile, at
   8,192 iterations and at 5 and 37) against theirs on the advance array
   and records of the encode kernel's block 0, exact, the record buffer,
   image and tile included; then the path: ``encode_stats`` on the 512
   fragments (the 9 held to the plain walk), ``chain`` and ``chainrec`` at
   200 walks, ``vcopy`` in both modes at twice the block's tags,
   ``coissue`` at nvec 0 and 8; timings of each kernel alone (``chain`` and
   ``chainrec`` in ns a walk step, ``coissue`` at every nvec and the vector
   stream alone in ns an iteration), ``encode_stats`` beside the encode
   kernel; the ptxas figures of ``encode_stats``, both ``chain`` forms and
   every ``coissue`` form (any stack or spill fails);
11. the isolation, branch, cliff and sort probes on the encode kernel's
   block 0: ``iso`` in its six modes (the records 20 times), ``bprobe`` at
   nwhen 0, 1, 3 and 8, ``cliff`` in its five modes at 200 walks and
   ``bitonic`` on the tool's keys and on keys with many ties, each against
   its plain version, exact, the image, scratch and indices included, and
   the chase (``cliff``'s walk with no body, the latency floor) against
   ``chain``'s plain version, and ``bprobe``'s floor (its mix alone) against
   its own; then the path, the same calls once each with exact launch
   counts; timings of each kernel alone, every built nwhen of ``bprobe``
   beside the floor (ns an iteration; ptxas figures of every ``bprobe``
   kernel and the floor, any stack or spill fails), the chase's ns a step
   beside each ``cliff`` mode's, and ``torch.sort`` of the same keys beside
   ``bitonic`` (one launch of one thread-block cluster; its ptxas figures,
   any stack or spill fails; both replayed from a CUDA graph). The probe
   kernel's row in the kernels line
   adds the bare launch's time beside the wrapper's and its floor: the
   longest walk's stride-8 steps at this run's chase link;
12. the fuzz campaigns of ``tools/torch_fuzz.py`` in process at its reduced
   volumes (``QUICK``): round trips of five data kinds through the encode
   and decode kernels, mutated blocks through the decode kernel beside
   valid rows at both loaders' row widths, the fragment ladder through the
   encode, best encode and decode kernels, the facade on both device
   engines with mutants, framed writes and framed mutants on the device
   engine (a flipped literal byte caught by the CRC32C kernel), the host
   engines; each judged by the oracle and the native engine, exact; then
   the codec at B=2,048 x 64 KiB (``bigbatch``): bodies through the native
   engine, CRCs against the host's, the native engine's streams through
   ``decompress_batch``. It prints rows, bytes, seconds and launches per
   campaign;
13. the tools: ``tools/torch_rehearsal_multihost.py`` at its defaults in a
   subprocess (4,096 x 64 KiB over 4 processes x 2 shards of the card, gloo
   over loopback; the joined stream and plaintext exact, the workers'
   launches summed into the path's); ``tools/torch_ratio_table.py``'s
   device columns (greedy, best, scan) on the card, equal to its CPU
   columns, each stream decoded by the oracle, best no larger than greedy;
   and ``utils.profiling.device_trace`` around one codec round trip of the
   phase-3 batch, whose Chrome trace must name ``encode_kernel`` and
   ``decode_kernel``, their device time printed beside phase 4's and
   ``Throughput``'s GB/s.

Each path (liveness, probe, codec, facade, stream, ablation, scan, sharded,
sharded_scan, encode_ablation, hybrid, micro_probes, isolation, fuzz, tools) runs with
the launch counts set to 0 just before it and read just after; every kernel of a
path must have launched, and the scan paths must launch none.
The line before the last is a JSON object listing each kernel with its
launches on those paths, its time, its bound and its plain version's
time; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

B = 512  # blocks per call, as bench.py (32 MiB per call)
BLOCK = 65536
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores (data sheet)

KERNELS = {  # launch-counter name -> (reported name, source, TPU kernel it replaces)
    "decode": ("decode_blocks_scalar", "snappier_tpu_torch/csrc/decode.cu",
               "snappier_tpu/ops/pallas/scalar_codec.py:167"),
    "encode": ("encode_blocks_scalar", "snappier_tpu_torch/csrc/encode.cu",
               "snappier_tpu/ops/pallas/scalar_codec.py:765"),
    "crc32c": ("crc32c_blocks", "snappier_tpu_torch/csrc/crc32c.cu",
               "snappier_tpu/ops/pallas/crc32c.py:43"),
    "encode_best": ("encode_blocks_best", "snappier_tpu_torch/csrc/encode_best.cu",
                    "snappier_tpu/ops/pallas/scalar_codec.py:964"),
    "probe": ("match_extension_probe", "snappier_tpu_torch/csrc/probe.cu",
              "snappier_tpu/ops/pallas/scalar_codec.py:704"),
    "watch": ("device_alive", "snappier_tpu_torch/csrc/watch.cu", "tools/tpu_watch.sh:23"),
    "decode_v2": ("decode_v2", "snappier_tpu_torch/csrc/decode_variants.cu",
                  "tools/perf_probe.py:45"),
    "decode_v4": ("decode_v4", "snappier_tpu_torch/csrc/decode_variants.cu",
                  "tools/perf_probe.py:300"),
    "decode_v3": ("decode_v3", "snappier_tpu_torch/csrc/decode_variants.cu",
                  "tools/perf_probe.py:548"),
    "decode_variant": ("decode_variant", "snappier_tpu_torch/csrc/decode_variants.cu",
                       "tools/perf_probe.py:793"),
    "encode_variant": ("encode_variant", "snappier_tpu_torch/csrc/encode_variants.cu",
                       "tools/perf_probe_enc.py:56"),
    "decode_pipe": ("decode_pipe", "snappier_tpu_torch/csrc/decode_pipe.cu",
                    "tools/perf_probe_r4.py:111"),
    "decode_pipe2": ("decode_pipe2", "snappier_tpu_torch/csrc/decode_pipe.cu",
                     "tools/perf_probe_r4.py:422"),
    "encode_r4": ("encode_r4", "snappier_tpu_torch/csrc/encode_r4.cu",
                  "tools/perf_probe_r4.py:784"),
    "decode_v5": ("decode_v5", "snappier_tpu_torch/csrc/decode_hybrid.cu",
                  "tools/perf_probe_hybrid.py:580"),
    "decode_v5_parts": ("decode_v5_spec", "snappier_tpu_torch/csrc/decode_hybrid.cu",
                        "tools/perf_probe_hybrid.py:827"),
    "decode_v6": ("decode_v6", "snappier_tpu_torch/csrc/decode_hybrid.cu",
                  "tools/perf_probe_hybrid.py:965"),
    "decode_v7": ("decode_v7", "snappier_tpu_torch/csrc/decode_hybrid.cu",
                  "tools/perf_probe_hybrid.py:1341"),
    "encode_stats": ("encode_stats", "snappier_tpu_torch/csrc/encode_stats.cu",
                     "tools/perf_probe_r4.py:1420"),
    "chain": ("chain", "snappier_tpu_torch/csrc/hybrid_probes.cu",
              "tools/perf_probe_hybrid.py:116"),
    "vcopy": ("vcopy", "snappier_tpu_torch/csrc/hybrid_probes.cu",
              "tools/perf_probe_hybrid.py:189"),
    "coissue": ("coissue", "snappier_tpu_torch/csrc/hybrid_probes.cu",
                "tools/perf_probe_hybrid.py:324"),
    "iso": ("iso", "snappier_tpu_torch/csrc/hybrid_probes.cu", "tools/perf_probe_hybrid.py:416"),
    "bprobe": ("bprobe", "snappier_tpu_torch/csrc/hybrid_probes.cu",
               "tools/perf_probe_hybrid.py:1225"),
    "cliff": ("cliff", "snappier_tpu_torch/csrc/hybrid_probes.cu",
              "tools/perf_probe_hybrid.py:1629"),
    "bitonic": ("bitonic", "snappier_tpu_torch/csrc/bitonic_probe.cu",
                "tools/perf_probe_hybrid.py:1724"),
}
PATHS = {  # path -> the kernels it must launch
    "liveness": ("watch",),
    "probe": ("probe",),
    "codec": ("encode", "decode", "crc32c"),
    "facade": ("encode", "encode_best", "best_candidates", "decode"),
    "stream": ("encode", "crc32c", "decode"),
    "ablation": ("decode", "decode_v2", "decode_v4", "decode_v3", "decode_variant"),
    "scan": (),  # tensor code: it must launch none of the kernels
    "sharded": ("encode", "decode"),
    "sharded_scan": (),
    "encode_ablation": ("encode", "decode", "encode_variant", "encode_r4", "decode_pipe",
                        "decode_pipe2"),
    "hybrid": ("decode", "decode_v5", "decode_v5_parts", "decode_v6", "decode_v7", "prepass_v5",
               "prepass_v6", "prepass_v7"),
    "micro_probes": ("encode_stats", "chain", "vcopy", "coissue"),
    "isolation": ("iso", "bprobe", "cliff", "bitonic"),
    "fuzz": ("encode", "encode_best", "decode", "crc32c"),
    "tools": ("encode", "encode_best", "decode"),
}
VARIANTS = ("v2", "v4", "v3", "v1", "v1nock", "v1nocp")
PROBE_ROWS = 300  # planted-match rows of 64 KiB beside the golden vectors
STREAM_CHUNKS = 2048  # 128 MiB: 8 sub-batches of 256 chunks
MIB = 1 << 20
SHARDS = 4  # the mesh of phase 8: one card listed four times


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def word_mix() -> bytes:
    """bench.py's seeded stand-in for the html corpus (bench.py:49-55)."""
    rng = np.random.default_rng(7)
    words = [b"<html>", b"<body>", b"the", b"snappy", b"corpus", b"fallback"]
    return b" ".join(words[i] for i in rng.integers(0, len(words), 40000))


def markup(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = [b"<html>", b"<body>", b"<div class=", b"the", b"snappy", b"corpus",
             b"fallback", b"</div>", b'href="/a/b"', b"\n"]
    s = b" ".join(words[i] for i in rng.integers(0, len(words), n // 2 + 8))
    return np.frombuffer(s[:n], np.uint8)


def cuda_ms(fn, iters: int = 5, passes: int = 3) -> float:
    """Best per-call milliseconds over ``passes`` runs of ``iters`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(passes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def graph_ms(fn, n: int = 20, passes: int = 3) -> float:
    """Device milliseconds per call of ``fn``: ``n`` calls captured in one
    CUDA graph on a side stream (after a warm-up call there), replayed,
    best of ``passes`` replays over ``n``; the host's time per call, which
    ``cuda_ms`` counts when it exceeds the kernel's, is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(passes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def best_host_ms(fn, passes: int = 3) -> float:
    """Best host wall-clock of ``passes`` calls of a function whose result
    ends on the host (so the device work is inside the time)."""
    return min(host_ms(fn) for _ in range(passes))


def ptxas_figures(log: str, needle: str) -> list:
    """ptxas's figures (``-Xptxas=-v``) for each kernel whose mangled name
    holds ``needle``: registers, stack frame and spill bytes."""
    figs, cur = {}, None
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.split()[-1]
            cur = figs.setdefault(name, {"function": name}) if needle in name else None
        elif cur is not None and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            cur.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur is not None and line.startswith("ptxas info") and "Used" in line:
            cur["registers"] = int(line.split("Used")[1].split()[0])
    return list(figs.values())


def max_abs_err(pairs) -> int:
    """Largest |a - b| over (kernel, plain) integer arrays of equal shape."""
    err = 0
    for a, b in pairs:
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        if a.shape != b.shape:
            raise AssertionError(f"shape {a.shape} != {b.shape}")
        if a.size:
            err = max(err, int(np.abs(a - b).max()))
    return err


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def forbidden(module, name: str):
    """Replace ``module.name`` with a function that raises, for the span of
    a path that must not take it."""
    saved = getattr(module, name)

    def refuse(*args, **kwargs):
        raise AssertionError(f"{module.__name__}.{name} was called")

    setattr(module, name, refuse)
    try:
        yield
    finally:
        setattr(module, name, saved)


def probe_batch():
    """The FindMatchLength golden vectors with expected length >= 4 (the
    walk runs only after a verified 4-byte seed) and PROBE_ROWS rows with
    planted matches, as 64 KiB rows: (bufs, ats, cands, ns, expected)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_match_length import VECTORS, _layout
    from torch_cases import planted_matches

    golden = [(e, *_layout(s1, s2, n)) for e, s1, s2, n in VECTORS if e >= 4]
    g_bufs = np.zeros((len(golden), BLOCK), np.uint8)
    for i, (_, buf, _, _) in enumerate(golden):
        g_bufs[i, : len(buf)] = np.frombuffer(buf, np.uint8)
    bufs, ats, cands, ns, planted = planted_matches(PROBE_ROWS, BLOCK)
    return (np.concatenate([g_bufs, bufs]),
            np.concatenate([[g[2] for g in golden], ats]).astype(np.int32),
            np.concatenate([np.zeros(len(golden)), cands]).astype(np.int32),
            np.concatenate([[g[3] for g in golden], ns]).astype(np.int32),
            np.concatenate([[g[0] for g in golden], planted]).astype(np.int32))


def probe_walk_steps(lengths, ats, ns) -> np.ndarray:
    """Stride-8 steps of the extension walk (``sc::extend_match``: its
    seed hook's calls) for matches of ``lengths`` at ``ats`` in rows of
    ``ns`` bytes: the first step compares the windows at 4 and 8 when 12
    bytes remain, each later one the next 8 bytes, and a step goes on only
    past a step whose 8 bytes all matched."""
    steps = []
    for ln, at, n in zip(lengths.tolist(), ats.tolist(), ns.tolist()):
        k, m, go = (1, 12, ln >= 12) if at + 12 <= n else (0, 4, True)
        while go and at + m + 8 <= n:
            k, go, m = k + 1, ln >= m + 8, m + 8
        steps.append(k)
    return np.array(steps, np.int64)


def encode_rows(rng):
    """Markup, random, all-zero, period-1..7 and short rows of 64 KiB with
    random garbage past each length."""
    lens = [BLOCK, BLOCK - 5, BLOCK, BLOCK] + [BLOCK - 3 * p for p in range(1, 8)]
    lens += [1, 15, 16, 17, 100]
    frags = rng.integers(0, 256, (len(lens), BLOCK), dtype=np.uint8)
    frags[0] = markup(BLOCK, 1)
    frags[1, : BLOCK - 5] = markup(BLOCK - 5, 2)
    frags[3] = 0
    for p in range(1, 8):
        r = 3 + p
        frags[r, : lens[r]] = np.tile(rng.integers(0, 256, p, dtype=np.uint8), BLOCK)[: lens[r]]
    for r in range(11, len(lens)):
        frags[r, : lens[r]] = markup(lens[r], r)
    return frags, np.array(lens, np.int32)


def corrupt_streams():
    """An empty row, a truncated tag, offset 0, offset > op, a bad
    preamble, a length mismatch and other malformed blocks."""
    lit4 = bytes([(4 - 1) << 2]) + b"abcd"
    return [
        b"",
        b"\xff\xff\xff\xff\xff",
        bytes([10, 3 << 2]) + b"ab",
        bytes([8]) + lit4 + bytes([2 | (3 << 2), 4]),
        bytes([8]) + lit4 + bytes([1, 0]),
        bytes([8]) + lit4 + bytes([1, 5]),
        bytes([9]) + lit4 + bytes([1, 4]),
        bytes([8]) + lit4 + bytes([3 | (3 << 2), 4, 0, 0, 0]),
        bytes([64, 0xFC, 0xFF, 0xFF, 0xFF, 0xFF]) + b"x" * 64,
        bytes([0x80, 0x80, 0x04]) + b"",  # claims 65536 + 0 bytes
        bytes([0x81, 0x80, 0x04]),  # claims 65537 > out_cap
    ]


def phase_kernels(torch, sc, crc, oracle, write_varint, exact_candidates):
    """Each kernel against its plain version; returns max_abs_err per kernel
    and the decode kernel's edge and corrupt streams."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_cases import batch_streams

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    errs = {}

    frags, lens = encode_rows(rng)
    f_h, l_h = torch.from_numpy(frags), torch.from_numpy(lens)
    bodies, body_lens = sc.encode_blocks_bytes(f_h.to(dev), l_h.to(dev))
    torch.cuda.synchronize()
    p_bodies, p_lens = sc.encode_blocks_plain(f_h, l_h, sc.HASH_BITS, 32)
    bodies, body_lens = bodies.cpu().numpy(), body_lens.cpu().numpy()
    p_bodies, p_lens = p_bodies.numpy(), p_lens.numpy()
    check((body_lens == p_lens).all(), f"encode lengths differ: {body_lens} vs {p_lens}")
    errs["encode"] = max_abs_err(
        [(body_lens, p_lens)] + [(bodies[i, :n], p_bodies[i, :n]) for i, n in enumerate(p_lens)]
    )
    for i, n in enumerate(lens):
        blk = write_varint(int(n)) + bodies[i, : body_lens[i]].tobytes()
        check(oracle.decompress(blk) == frags[i, :n].tobytes(), f"encode row {i} round trip")
    print(f"encode kernel == plain on {len(lens)} rows, max_abs_err {errs['encode']}")
    # The same rows 1 byte into a larger buffer (the byte loader), and at
    # width 65,535 with the last row full, ending at the buffer's end.
    buf = torch.zeros(frags.size + 1, dtype=torch.uint8, device=dev)
    view = buf[1:].view(frags.shape)
    view.copy_(f_h.to(dev))
    check(sc.encode_layout(view)["loader"] == "bytes", "an unaligned view takes the byte loader")
    u_bodies, u_lens = (x.cpu().numpy() for x in sc.encode_blocks_bytes(view, l_h.to(dev)))
    odd_f = np.concatenate([frags[:, : BLOCK - 1], frags[:1, : BLOCK - 1]])
    odd_l = np.concatenate([np.minimum(lens, BLOCK - 1), [BLOCK - 1]]).astype(np.int32)
    o_h, ol_h = torch.from_numpy(odd_f), torch.from_numpy(odd_l)
    o_bodies, o_lens = (x.cpu().numpy()
                        for x in sc.encode_blocks_bytes(o_h.to(dev), ol_h.to(dev)))
    po_bodies, po_lens = (x.numpy() for x in sc.encode_blocks_plain(o_h, ol_h, sc.HASH_BITS, 32))
    check((u_lens == p_lens).all() and (o_lens == po_lens).all(), "unaligned encode lengths")
    err = max_abs_err(
        [(u_lens, p_lens), (o_lens, po_lens)]
        + [(u_bodies[i, :n], p_bodies[i, :n]) for i, n in enumerate(p_lens)]
        + [(o_bodies[i, :n], po_bodies[i, :n]) for i, n in enumerate(po_lens)])
    check(err == 0, "the encode kernel differs from its plain version on unaligned rows")
    print(f"encode kernel == plain on the rows 1 byte into a buffer and on {len(odd_l)} rows of "
          f"{BLOCK - 1} B, max_abs_err {err}")

    streams = corrupt_streams() + [
        write_varint(int(n)) + bodies[i, : body_lens[i]].tobytes() for i, n in enumerate(lens)
    ]
    cc = 68608
    comp = rng.integers(0, 256, (len(streams), cc), dtype=np.uint8)
    clens = np.zeros(len(streams), np.int32)
    for i, s in enumerate(streams):
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
        clens[i] = len(s)
    c_h, cl_h = torch.from_numpy(comp), torch.from_numpy(clens)
    out, out_lens, derr = sc.decode_blocks_bytes(c_h.to(dev), cl_h.to(dev), BLOCK)
    torch.cuda.synchronize()
    p_out, p_olens, p_derr = (x.numpy() for x in sc.decode_blocks_plain(c_h, cl_h, BLOCK))
    out, out_lens, derr = out.cpu().numpy(), out_lens.cpu().numpy(), derr.cpu().numpy()
    check((derr == p_derr).all(), f"decode errors differ: {derr} vs {p_derr}")
    check((out_lens == p_olens).all(), f"decode lengths differ: {out_lens} vs {p_olens}")
    errs["decode"] = max_abs_err(
        [(derr, p_derr), (out_lens, p_olens)]
        + [(out[i, :n], p_out[i, :n]) for i, n in enumerate(p_olens)]
    )
    n_bad = len(corrupt_streams())
    check((derr[1:n_bad] != 0).sum() >= n_bad - 3 and derr[0] == 8, f"corrupt rows: {derr}")
    check((derr[n_bad:] == 0).all(), "encoded rows must decode")
    print(f"decode kernel == plain on {len(streams)} rows (errors {derr[:n_bad].tolist()}),"
          f" max_abs_err {errs['decode']}")
    # The same rows 1 byte into a larger buffer (the byte loader); the batch
    # walk's edges (overlapping copies at every phase of a round, copies of
    # the batch's own output, literals with 1-4 length bytes, tag programs)
    # at a width that ends at the longest stream and at an out_cap that is
    # not a multiple of 16, the last row ending at its buffer's end.
    edges = batch_streams()
    e_comp = rng.integers(0, 256, (len(edges), max(map(len, edges))), dtype=np.uint8)
    e_lens = np.array([len(e) for e in edges], np.int32)
    for i, e in enumerate(edges):
        e_comp[i, : len(e)] = np.frombuffer(e, np.uint8)
    e_comp[-1] = np.frombuffer(max(edges, key=len), np.uint8)
    e_lens[-1] = e_comp.shape[1]
    cases = []
    for rows_h, lens_h, cap in ((c_h, cl_h, BLOCK), (torch.from_numpy(e_comp),
                                                     torch.from_numpy(e_lens), 8190)):
        ubuf = torch.zeros(rows_h.numel() + 1, dtype=torch.uint8, device=dev)
        uview = ubuf[1:].view(rows_h.shape)
        uview.copy_(rows_h.to(dev))
        check(sc.decode_layout(uview, cap)["loader"] == "bytes",
              "an unaligned view takes the byte loader")
        want = [x.numpy() for x in sc.decode_blocks_plain(rows_h, lens_h, cap)]
        for rows_d in (uview, rows_h.to(dev)):
            got = [x.cpu().numpy() for x in sc.decode_blocks_bytes(rows_d, lens_h.to(dev), cap)]
            check((got[2] == want[2]).all() and (got[1] == want[1]).all(),
                  f"decode triple differs at out_cap {cap}")
            cases += [(got[2], want[2]), (got[1], want[1])] + [
                (got[0][i, :n], want[0][i, :n]) for i, n in enumerate(want[1])]
    err = max_abs_err(cases)
    check(err == 0, "the decode kernel differs from its plain version on the byte loader")
    errs["decode"] = max(errs["decode"], err)
    print(f"decode kernel == plain on those rows 1 byte into a buffer and on {len(edges)} "
          f"batch-edge rows at out_cap 8190 (both loaders), max_abs_err {err}")

    # K3: the edge lengths of its split, garbage past them, at 64 KiB, then
    # 1 byte into a buffer (every row past a 16-byte boundary), at odd widths
    # (each row at another offset) and as 2,048 rows (more than the
    # persistent blocks).
    from torch_cases import crc_rows

    pairs, n_rows = [], 0
    for width, offset, n in ((BLOCK, 0, 0), (BLOCK, 1, 0), (BLOCK - 1, 0, 0), (4097, 3, 0),
                             (BLOCK, 0, 2048)):
        rows, clen = crc_rows(width)
        base = len(clen)
        if n > base:  # repeated to n rows, each past the first set made anew
            rows, clen = np.tile(rows, (-(-n // base), 1))[:n], np.tile(clen, -(-n // base))[:n]
            rows[base:] ^= rng.integers(0, 256, rows[base:].shape, dtype=np.uint8)
        crc_buf = torch.zeros(rows.size + offset, dtype=torch.uint8, device=dev)
        crc_view = crc_buf[offset:].view(rows.shape)
        crc_view.copy_(torch.from_numpy(rows).to(dev))
        got = crc.crc32c_blocks(crc_view, torch.from_numpy(clen).to(dev))
        torch.cuda.synchronize()
        want = crc.crc32c_blocks_plain(torch.from_numpy(rows), torch.from_numpy(clen)).numpy()
        got = got.cpu().numpy()
        check((got == want).all(), f"crc32c differs at width {width}, offset {offset}")
        pairs.append((got.view(np.uint32), want.view(np.uint32)))
        n_rows += len(rows)
    errs["crc32c"] = max_abs_err(pairs)
    print(f"crc32c kernel == plain on {n_rows} rows (edge lengths, 1 byte into a buffer, "
          f"widths {BLOCK - 1} and 4097, 2048 rows), max_abs_err {errs['crc32c']}")

    f_c, l_c = f_h.to(dev), l_h.to(dev)
    cands = exact_candidates(f_c, l_c)
    check(bool((cands.cpu() == exact_candidates(f_h, l_h)).all()),
          "exact_candidates differs between the card and the CPU")
    bodies, body_lens = sc._encode_best(f_c, l_c, cands)
    torch.cuda.synchronize()
    p_bodies, p_lens = (x.numpy() for x in sc.encode_best_plain(f_h, l_h, cands.cpu(), 32))
    bodies, body_lens = bodies.cpu().numpy(), body_lens.cpu().numpy()
    check((body_lens == p_lens).all(), f"encode_best lengths differ: {body_lens} vs {p_lens}")
    errs["encode_best"] = max_abs_err(
        [(body_lens, p_lens)] + [(bodies[i, :n], p_bodies[i, :n]) for i, n in enumerate(p_lens)]
    )
    for i, n in enumerate(lens):
        blk = write_varint(int(n)) + bodies[i, : body_lens[i]].tobytes()
        check(oracle.decompress(blk) == frags[i, :n].tobytes(), f"encode_best row {i} round trip")
    print(f"encode_best kernel == plain on {len(lens)} rows, max_abs_err {errs['encode_best']}")
    # The same rows 1 byte into a larger buffer (the byte loader).
    check(sc.best_layout(view)["loader"] == "bytes", "an unaligned view takes the byte loader")
    got_b, got_l = (x.cpu().numpy() for x in sc._encode_best(view, l_c, cands))
    err = max_abs_err([(got_l, p_lens)] +
                      [(got_b[i, :n], p_bodies[i, :n]) for i, n in enumerate(p_lens)])
    check(err == 0, "encode_best differs from its plain version unaligned")
    errs["encode_best"] = max(errs["encode_best"], err)
    print(f"encode_best kernel == plain on the rows 1 byte into a buffer, max_abs_err {err}")
    return errs, streams


def phase_candidates(torch, card, _build, frags, lengths) -> dict:
    """The candidate search's kernel at the main path's shape: layout,
    ptxas figures, one launch, its candidates against the plain version on
    the card (the tensor chain, which is also timed, as ``library_ms``) and
    on the CPU for four rows, no width sorted whole, its time with CUDA
    events. Returns the JSON line's fields."""
    from snappier_tpu_torch.ops import best_match as bm

    B_, F = frags.shape
    layout = bm.candidates_layout(F, frags.device)
    ptxas = ptxas_figures(_build.BUILD_LOG.get("best_candidates", ""), "best_candidates_kernel")
    check(len(ptxas) == 1, f"ptxas figures of best_candidates: {ptxas}")
    check(layout["ctas"] == 8 and layout["clusters"] >= 1, f"best_candidates layout {layout}")
    fallbacks = torch.zeros(1, dtype=torch.int32, device=frags.device)
    _build.reset_launches()
    got = bm.launch_candidates(frags, lengths, bm.DEFAULT_WIDTHS, fallbacks)
    torch.cuda.synchronize()
    check(dict(_build.LAUNCHES) == {"best_candidates": 1},
          f"best_candidates launches {dict(_build.LAUNCHES)}")
    chain = bm.exact_candidates_plain(frags, lengths)
    check(bool((got == chain).all()), "best_candidates differs from the tensor chain on the card")
    rows = [0, 1, B_ // 2, B_ - 1]
    cpu = bm.exact_candidates_plain(frags[rows].cpu(), lengths[rows].cpu())
    check(bool((got[rows].cpu() == cpu).all()), "best_candidates differs from the CPU's")
    check(int(fallbacks) == 0, f"{int(fallbacks)} widths sorted whole on the main path")
    f1, l1 = frags[:1].cpu(), lengths[:1].cpu()
    n_in = B_ * F
    out = {
        "card": card, "layout": layout, "ptxas": ptxas,
        "ms": cuda_ms(lambda: bm.exact_candidates(frags, lengths)),
        "library_ms": cuda_ms(lambda: bm.exact_candidates_plain(frags, lengths), iters=2),
        "plain_ms": host_ms(lambda: bm.exact_candidates_plain(f1, l1)), "plain_rows": 1,
        "plain_device": "cpu",
        # the rows and lengths in, the int32 candidates out, once each
        "bound_ms": (n_in + 4 * B_ + 4 * n_in) / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": 0,
    }
    print(json.dumps({"best_candidates": out}))
    return out


def phase_probe(torch, sc, _build):
    """The probe path: golden vectors and planted matches through the probe
    kernel, held against the expected lengths and the plain version.
    Returns (max_abs_err, launches on the path, probe inputs on the card,
    expected lengths)."""
    dev = torch.device("cuda")
    bufs, ats, cands, ns, expected = probe_batch()
    host = [torch.from_numpy(x) for x in (bufs, ats, cands, ns)]
    args = [x.to(dev) for x in host]
    torch.cuda.synchronize()
    _build.reset_launches()
    got = sc.match_extension_probe(*args)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches.get("probe", 0) > 0, "kernel probe did not launch on the probe path")
    got = got.cpu().numpy()
    want = sc.match_extension_probe(*host).numpy()
    check((got == want).all(), "probe kernel differs from its plain version")
    check((got == expected).all(), "probe lengths differ from the golden and planted lengths")
    err = max_abs_err([(got, want)])
    print(f"probe kernel == plain == expected on {len(got)} rows "
          f"({len(got) - PROBE_ROWS} golden vectors), max_abs_err {err}")
    return err, launches, args, expected


def phase_facade(torch, st, block, native, prescan, _build, raw: bytes):
    """The public facade at full size on ``raw``. Returns (launches on the
    path, the fast stream, the best stream)."""
    check(native.available(), "the native runtime did not build (prescan needs it)")
    # The path must split every stream on the card: neither the Python
    # prescan walk nor the window-crossing host decode may run.
    with forbidden(block, "_host_decode"), forbidden(prescan, "scan_fragments_py"):
        torch.cuda.synchronize()
        _build.reset_launches()
        fast = st.compress(raw)
        best = st.compress(raw, level="best")
        back_fast = st.decompress(fast)
        back_best = st.decompress(best)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    print(f"facade path launches: {launches}")
    for k in PATHS["facade"]:
        check(launches.get(k, 0) > 0, f"kernel {k} did not launch on the facade path")
    check(back_fast == raw, "facade round trip differs (fast)")
    check(back_best == raw, "facade round trip differs (best)")
    check(len(best) <= len(fast), f"best ({len(best)} B) is larger than fast ({len(fast)} B)")
    check(native.decompress(best) == raw, "native decode of the best stream differs")
    check(native.decompress(fast) == raw, "native decode of the fast stream differs")
    print(f"facade: {len(raw)} B round trip exact at both levels; fast {len(fast)} B, "
          f"best {len(best)} B; both decode through the native engine")

    part = raw[: 1 << 20]
    out = bytearray(st.get_max_compressed_length(len(part)))
    n = st.compress_into(part, out)
    comp = bytes(out[:n])
    check(comp == st.compress(part), "compress_into differs from compress")
    plain = bytearray(len(part))
    check(st.decompress_into(comp, plain) == len(part) and plain == part, "decompress_into")
    with st.compress_to_memory(part) as m:
        check(bytes(m) == comp, "compress_to_memory")
    with st.decompress_to_memory(comp) as m:
        check(bytes(m) == part, "decompress_to_memory")
    check(st.try_compress(part, bytearray(16)) == (False, 0), "try_compress on 16 bytes")
    try:
        st.decompress(comp[:-7])
        raise AssertionError("a truncated stream decoded")
    except st.InvalidDataError:
        pass
    print("facade on 1 MiB: *_into, *_to_memory, try_compress and a truncated stream ok")
    return launches, fast, best


def phase_liveness(torch, watch, _build):
    """Phase 0: the salted kernel compiles afresh, launches and agrees with
    its plain version. Returns (max_abs_err, launches on the path, the
    timings of :func:`watch_times`, plain ms on the CPU)."""
    salt = watch.fresh_salt()
    _build.reset_launches()
    t0 = time.perf_counter()
    y = watch.device_alive(salt)
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches.get("watch", 0) == 1, "kernel watch did not launch on the liveness path")
    x_h = torch.arange(y.numel(), dtype=torch.int32).reshape(watch.SHAPE)
    err = max_abs_err([(y.cpu().numpy(), watch.add_salt_plain(x_h, salt).numpy())])
    check(err == 0 and int(y[0, 0]) == salt, "liveness kernel differs from its plain version")
    check(not list(_build.BUILD_DIR.glob("libwatch-*")), "a salted library was left in build/")
    print(f"liveness: salt {salt}, fresh compile + launch + check in {secs:.2f} s, "
          f"max_abs_err {err}")
    x = x_h.cuda()
    with watch.salted_launcher(salt + 1) as fn:  # one more build, kept for the timing
        t = watch_times(torch, watch, _build, fn, x, salt + 1)
    print(json.dumps({"liveness_ms_per_call": t}))
    plain_ms = min(host_ms(lambda: watch.add_salt_plain(x_h, salt)) for _ in range(5))
    return err, launches, t, plain_ms


def watch_times(torch, watch, _build, fn, x, salt: int, n: int = 50) -> dict:
    """T21 beside ``torch.add(x, salt)`` on the same tensor, ms per call:
    (a) ``cuda_ms`` over ``n`` calls back to back, host included, in turns
    with ``torch.add``, the best of four; (b) the bare launcher with the
    stream handle fetched once (CUDA events), each wrapper's host time
    alone (host clock over ``n`` calls, no wait), and T21's in parts:
    ``torch.empty_like``, ``launch_bound`` and the two ways to read the
    current stream's handle; (c) the device time of a
    launch: ``n`` launches captured in one CUDA graph, replayed, over ``n``.
    Each graph's output is held to the plain version."""
    want = watch.add_salt_plain(x.cpu(), salt)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), y.data_ptr(), x.numel())

    def bare():
        check(fn(*args, stream) == 0, "the watch launcher failed")

    def host_per_call(call):
        call()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            best = min(best, (time.perf_counter() - t0) * 1e3 / n)
            torch.cuda.synchronize()
        return best

    def graph_per_launch(capture):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            capture()  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = [capture() for _ in range(n)]
        return cuda_ms(g.replay, iters=10) / n, out[-1]

    def capture_kernel():
        check(fn(*args, torch.cuda.current_stream().cuda_stream) == 0, "launch in capture")
        return y

    # In turns (kernel, torch.add, torch.add, kernel, ...), the best of each.
    t = {}
    for turn in range(4):
        pair = [("a_add_salt", lambda: cuda_ms(lambda: watch.add_salt(x, salt, fn), iters=n)),
                ("a_torch_add", lambda: cuda_ms(lambda: torch.add(x, salt), iters=n)),
                ("b_add_salt_host", lambda: host_per_call(lambda: watch.add_salt(x, salt, fn))),
                ("b_torch_add_host", lambda: host_per_call(lambda: torch.add(x, salt)))]
        for key, measure in (pair if turn % 2 == 0 else pair[::-1]):
            t[key] = min(t.get(key, float("inf")), measure())
    t["b_bare_launcher"] = cuda_ms(bare, iters=n)
    # add_salt's host time in parts: its output, and the launch alone.
    t["b_empty_like_host"] = host_per_call(lambda: torch.empty_like(x))
    t["b_launch_bound_host"] = host_per_call(
        lambda: _build.launch_bound(fn, "watch_timing", x.get_device(), *args))
    _build.LAUNCHES.pop("watch_timing", None)
    # The current stream's handle, which launch_bound reads at each call, by
    # the public call (it builds a torch.cuda.Stream) and by the raw one.
    dev = x.get_device()
    t["b_current_stream_host"] = host_per_call(lambda: torch.cuda.current_stream(dev).cuda_stream)
    t["b_raw_stream_host"] = host_per_call(lambda: torch._C._cuda_getCurrentRawStream(dev))
    t["c_graph_kernel"], g_y = graph_per_launch(capture_kernel)
    t["c_graph_torch_add"], g_add = graph_per_launch(lambda: torch.add(x, salt))
    torch.cuda.synchronize()
    check(bool((g_y.cpu() == want).all()) and bool((g_add.cpu() == want).all()),
          "the graph-replayed kernel or torch.add differs from the plain version")
    return t


def k3_times(torch, crc, _build, rows, lengths, n: int = 50) -> dict:
    """K3 on uint8 ``rows`` and ``lengths``, ms per call: (a) the wrapper,
    ``cuda_ms`` over ``n`` calls back to back; (b) the bare launcher with the
    stream handle fetched once (CUDA events); (c) the device time of a
    launch: ``n`` launches of the bare launcher captured in one CUDA graph,
    replayed, over ``n``, on the same rows (which the 50 MB L2 may hold) and
    (``c_graph_cold``) on copies of them that take turns, 128 MiB or more in
    all, so that each launch reads rows the last ones evicted. Each graph's
    output is held to the plain version."""
    fn = _build.launcher("crc32c")
    rows, lengths = rows.contiguous(), lengths.to(torch.int32).contiguous()
    B, F = rows.shape
    tables = crc._device_tables(rows.device)
    out = torch.empty(B, dtype=torch.int32, device=rows.device)
    n_copies = min(n, -(-(128 * MIB) // max(rows.numel(), 1)))
    copies = [rows] + [rows.clone() for _ in range(n_copies - 1)]
    cold_out = torch.empty(len(copies), B, dtype=torch.int32, device=rows.device)

    def args(i, dst):
        return (copies[i].data_ptr(), F, lengths.data_ptr(), B, tables.data_ptr(), dst)

    stream = torch.cuda.current_stream().cuda_stream

    def bare():
        check(fn(*args(0, out.data_ptr()), stream) == 0, "the crc32c launcher failed")

    want = crc.crc32c_blocks_plain(rows.cpu(), lengths.cpu())

    def graph_per_launch(cold: bool):
        dsts = cold_out if cold else out[None]

        def capture():
            s = torch.cuda.current_stream().cuda_stream
            for k in range(n):
                i = k % len(copies) if cold else 0
                check(fn(*args(i, dsts[i].data_ptr()), s) == 0, "crc32c launch in capture")

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            capture()  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            capture()
        dsts.zero_()
        ms = cuda_ms(g.replay, iters=10) / n
        check(bool((dsts.cpu() == want).all()),
              "a graph-replayed crc32c differs from the plain version")
        return ms

    return {"a_wrapper": cuda_ms(lambda: crc.crc32c_blocks(rows, lengths), iters=n),
            "b_bare_launcher": cuda_ms(bare, iters=n),
            "c_graph": graph_per_launch(False), "c_graph_cold": graph_per_launch(True)}


def stream_bytes(n_chunks: int) -> bytes:
    """``n_chunks`` x 64 KiB of the word mix with every eighth chunk random
    bytes, so a stream of it holds compressed and stored chunks."""
    html = word_mix()
    rows = np.frombuffer((html * (-(-n_chunks * BLOCK // len(html))))[: n_chunks * BLOCK],
                         np.uint8).reshape(n_chunks, BLOCK).copy()
    rng = np.random.default_rng(23)
    rows[7::8] = rng.integers(0, 256, (len(rows[7::8]), BLOCK), dtype=np.uint8)
    return rows.tobytes()


def expect_invalid(st, what: str, fn) -> None:
    try:
        fn()
    except st.InvalidDataError:
        return
    raise AssertionError(f"{what} was accepted")


def phase_streams(torch, card: str):
    """Phase 6: the stream entry points at full size. Returns the launches
    of the one-shot round trip and K3's times on a sub-batch and on its
    decoded rows (:func:`k3_times`)."""
    import snappier_tpu_torch as st
    from snappier_tpu_torch.format import framing
    from snappier_tpu_torch.models.codec import compact_words
    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import crc32c as crc
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc
    from snappier_tpu_torch.runtime import incremental, native
    from snappier_tpu_torch.runtime import stream as S

    dev = torch.device("cuda")
    raw = stream_bytes(STREAM_CHUNKS)
    n_sub = STREAM_CHUNKS // S._SUB_BATCH
    n_stored = STREAM_CHUNKS // 8
    n_sub_read = -(-(STREAM_CHUNKS - n_stored) // S._SUB_BATCH)

    # The one-shot round trip. On the write side no host CRC may run at all,
    # on the read side none of a decoded chunk (stored chunks are checked on
    # the host while the feed is parsed).
    torch.cuda.synchronize()
    _build.reset_launches()
    with forbidden(S, "crc32c"), forbidden(native, "crc32c"):
        framed = st.stream_compress(raw)
    torch.cuda.synchronize()
    wrote = dict(_build.LAUNCHES)
    check(wrote == {"encode": n_sub, "crc32c": n_sub}, f"write-side launches {wrote}")
    with forbidden(S, "_host_crc_of_decoded"):
        back = st.stream_decompress(framed)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches == {"encode": n_sub, "crc32c": n_sub + n_sub_read, "decode": n_sub_read},
          f"stream path launches {launches}")
    for k in PATHS["stream"]:
        check(launches.get(k, 0) > 0, f"kernel {k} did not launch on the stream path")
    check(back == raw, "stream round trip differs")
    types = [t for t, _, _ in framing.iter_chunks(framed)]
    check(types.count(0x00) == STREAM_CHUNKS - n_stored and types.count(0x01) == n_stored,
          "chunk types of the stream")
    print(f"stream path launches: {launches}; {len(raw)} B round trip exact, "
          f"{len(framed)} B framed ({types.count(0)} compressed and {types.count(1)} stored chunks)")

    check(native.stream_decompress(framed) == raw, "native decode of the device stream differs")
    small = raw[: 4 * MIB]
    framed_small = st.stream_compress(small)
    check(framed_small == framed[: len(framed_small)], "a prefix's stream is not a stream prefix")
    check(framing.frame_decompress(framed_small) == small, "framing oracle decode differs")
    part = raw[: 32 * MIB]
    check(st.stream_decompress(native.stream_compress(part)) == part,
          "device decode of a native stream differs")
    print("device stream decodes through the native engine and the framing oracle; "
          "a native stream decodes on the card")

    reader_ms = {}
    sink = io.BytesIO()
    t0 = time.perf_counter()
    with st.SnappyWriter(sink, leave_open=True) as w:
        for i in range(0, len(part), MIB):
            w.write(part[i : i + MIB])
    writer_ms = (time.perf_counter() - t0) * 1e3
    check(sink.getvalue() == framed[: len(sink.getvalue())] and st.stream_decompress(
        sink.getvalue()) == part, "SnappyWriter stream differs")
    for transfer in (8192, MIB):
        _build.reset_launches()
        t0 = time.perf_counter()
        with st.SnappyReader(io.BytesIO(sink.getvalue()), transfer_size=transfer) as r:
            got = r.read()
        reader_ms[transfer] = (time.perf_counter() - t0) * 1e3
        check(got == part, f"SnappyReader at {transfer} B transfers differs")
        print(f"SnappyReader on {len(part)} B at {transfer} B transfers: "
              f"{_build.LAUNCHES['decode']} decode launches, {reader_ms[transfer]:.1f} ms")

    async def twins():
        out = io.BytesIO()
        async with st.AsyncSnappyWriter(out, leave_open=True) as w:
            for i in range(0, len(small), MIB):
                await w.write(small[i : i + MIB])
        async with st.AsyncSnappyReader(io.BytesIO(out.getvalue())) as r:
            return out.getvalue(), await r.read()

    a_framed, a_back = asyncio.run(twins())
    check(a_framed == framed_small and a_back == small, "async twins differ")

    half = raw[: 16 * MIB]
    pieces = [half[i : i + MIB + 1] for i in range(0, len(half), MIB + 1)]
    comp = incremental.compress_iter(pieces)
    check(comp == st.compress(half), "compress_iter differs from compress")
    sunk = []
    n = incremental.compress_iter(pieces, writer=sunk.append, batch_blocks=32)
    check(n == len(comp) and b"".join(sunk) == comp, "compress_iter writer mode differs")
    blocks = [comp[i : i + 65521] for i in range(0, len(comp), 65521)]
    check(incremental.decompress_iter(blocks) == half, "decompress_iter differs")
    sunk = []
    check(incremental.decompress_iter(blocks, writer=sunk.append) == len(half)
          and b"".join(sunk) == half, "decompress_iter writer mode differs")
    print("SnappyWriter, async twins on 4 MiB and compress_iter / decompress_iter on 16 MiB ok")

    flip = lambda s, i: s[:i] + bytes([s[i] ^ 0xFF]) + s[i + 1 :]  # noqa: E731
    f1 = st.stream_compress(raw[: MIB])
    expect_invalid(st, "a flipped CRC byte", lambda: st.stream_decompress(flip(f1, 14)))
    expect_invalid(st, "a flipped payload byte", lambda: st.stream_decompress(flip(f1, 5000)))
    expect_invalid(st, "a flipped stored byte",
                   lambda: st.stream_decompress(flip(f1, len(f1) - 1)))
    expect_invalid(st, "a truncated tail", lambda: st.stream_decompress(f1[:-3]))
    expect_invalid(st, "a headerless stream", lambda: st.stream_decompress(f1[10:]))
    expect_invalid(st, "an unknown unskippable chunk type", lambda: st.stream_decompress(
        f1[:10] + bytes([0x40, 1, 0, 0, 0]) + f1[10:]))
    ok = f1[:10] + bytes([0xFE, 2, 0, 0, 0, 0]) + bytes([0x90, 1, 0, 0, 7]) + f1[10:]
    check(st.stream_decompress(ok) == raw[: MIB], "skippable and padding chunks")
    check(st.stream_compress(b"") == framed[:10] and st.stream_decompress(framed[:10]) == b"",
          "empty stream")
    print("corrupt probes raise InvalidDataError; skippable and padding chunks are skipped")

    # The decode-side function on the card against the CPU, on a few rows.
    payloads = [p[4:] for t, p, _ in framing.iter_chunks(f1) if t == 0x00][:6]
    payloads.append(bytes([100, 4 << 2]) + b"abcde")  # claims 100 bytes, holds 5
    width = -(-max(len(p) for p in payloads) // 16) * 16
    comp_h = np.zeros((len(payloads), width), np.uint8)
    for i, pl in enumerate(payloads):
        comp_h[i, : len(pl)] = np.frombuffer(pl, np.uint8)
    lens_h = np.array([len(pl) for pl in payloads], np.int32)
    on_card = S._decode_crc_pack(torch.from_numpy(comp_h).to(dev), torch.from_numpy(lens_h).to(dev))
    on_cpu = S._decode_crc_pack(torch.from_numpy(comp_h), torch.from_numpy(lens_h))
    for name, a, b in zip(("out_lens", "errs", "crcs"), on_card[1:], on_cpu[1:]):
        check(bool((a.cpu() == b).all()), f"decode-side {name} differ between card and CPU")
    for i, n in enumerate(on_cpu[1].tolist()):
        check(bool((on_card[0][i].cpu().view(torch.uint8)[:n] == on_cpu[0][i].view(
            torch.uint8)[:n]).all()), f"decode-side row {i} differs")
    errs_h = on_cpu[2].tolist()
    check(not any(errs_h[:-1]) and errs_h[-1] != 0, f"decode-side errors {errs_h}")
    print("decode-side function (decode, CRC32C of the decoded rows, packing): card == CPU")

    # --- timings ---------------------------------------------------------------
    def with_depth(depth: int, fn):
        saved = S._PIPELINE_DEPTH
        S._PIPELINE_DEPTH = depth
        try:
            return best_host_ms(fn, passes=2)
        finally:
            S._PIPELINE_DEPTH = saved

    t = {"compress_ms": [], "compress_serial_ms": [], "decompress_ms": [],
         "decompress_serial_ms": []}
    for _ in range(2):  # pipelined, serial, serial, pipelined: one card, in turns
        for depth, tag in ((3, ""), (0, "_serial"), (0, "_serial"), (3, "")):
            t[f"compress{tag}_ms"].append(with_depth(depth, lambda: st.stream_compress(raw)))
            t[f"decompress{tag}_ms"].append(with_depth(depth, lambda: st.stream_decompress(framed)))
    wall = {k: min(v) for k, v in t.items()}

    # The stages of one sub-batch, each alone: host staging, the copy across,
    # the device graph (kernels inside it timed by themselves), the fetch.
    chunks = [raw[i : i + BLOCK] for i in range(0, S._SUB_BATCH * BLOCK, BLOCK)]

    def stage_chunks():
        stage = S._Stage(len(chunks), BLOCK, dev)
        for j, c in enumerate(chunks):
            stage.rows[j] = np.frombuffer(c, np.uint8)
            stage.lens[j] = len(c)
        return stage

    stage = stage_chunks()
    frags, lengths = stage.to(dev)
    codec = st.SnappyCodec(with_crc=True)
    packed, flens = codec.frame_batch_packed(frags, lengths)
    wl = (flens + 3) >> 2
    total_w = int(wl.sum())
    comp_rows = [p[4:] for t_, p, _ in framing.iter_chunks(framed) if t_ == 0x00][: S._SUB_BATCH]
    cw = -(-max(len(p) for p in comp_rows) // 16) * 16
    cstage = S._Stage(len(comp_rows), cw, dev)
    for j, pl in enumerate(comp_rows):
        cstage.rows[j, : len(pl)] = np.frombuffer(pl, np.uint8)
        cstage.lens[j] = len(pl)
    comp_d, clens_d = cstage.to(dev)
    outs = sc.decode_blocks_bytes(comp_d, clens_d, BLOCK)
    sub = {
        "stage_256_chunks_host_ms": best_host_ms(lambda: stage_chunks().release()),
        "copy_across_ms": cuda_ms(lambda: stage.to(dev)),
        "frame_batch_packed_ms": cuda_ms(lambda: codec.frame_batch_packed(frags, lengths)),
        "encode_256_ms": cuda_ms(lambda: sc.encode_blocks_bytes(frags, lengths)),
        "crc_256_ms": cuda_ms(lambda: crc.crc32c_blocks(frags, lengths)),
        "compact_ms": cuda_ms(lambda: compact_words(packed, wl, total_w)),
        "fetch_framed_ms": best_host_ms(lambda: compact_words(packed, wl, total_w).cpu()),
        "decode_crc_pack_ms": cuda_ms(lambda: S._decode_crc_pack(comp_d, clens_d)),
        "decode_256_ms": cuda_ms(lambda: sc.decode_blocks_bytes(comp_d, clens_d, BLOCK)),
        "crc_decoded_256_ms": cuda_ms(lambda: crc.crc32c_blocks(outs[0], outs[1])),
        "crc_256_by_method": k3_times(torch, crc, _build, frags, lengths),
        "crc_decoded_256_by_method": k3_times(torch, crc, _build, outs[0], outs[1]),
        "fetch_decoded_ms": best_host_ms(lambda: outs[0].cpu()),
        "join_128MiB_host_ms": best_host_ms(lambda: b"".join(chunks * n_sub)),
    }
    torch.cuda.synchronize()
    stage.release()
    cstage.release()
    print(json.dumps({
        "card": card, "stream_bytes": len(raw), "framed_bytes": len(framed),
        "sub_batches_write": n_sub, "sub_batches_read": n_sub_read, **wall,
        "compress_gbps": len(raw) / wall["compress_ms"] / 1e6,
        "decompress_gbps": len(raw) / wall["decompress_ms"] / 1e6,
        "writer_32MiB_ms": writer_ms, "reader_32MiB_8KiB_ms": reader_ms[8192],
        "reader_32MiB_1MiB_ms": reader_ms[MIB], "all_runs_ms": t, "per_sub_batch": sub,
    }))
    return launches, {"256": sub["crc_256_by_method"],
                      "decoded_256": sub["crc_decoded_256_by_method"]}


def redesign_turns(torch, card, sc, frags, lengths, cands, comp_u8, block_lens):
    """K1 and K4 on the main path's 512 blocks beside T4 v1 (K1's batched
    walk, every round of a step stored whole), in turns (each timed twice,
    the second time in the reverse order); returns K4's layout and the
    times."""
    from snappier_tpu_torch.ops.cuda import decode_variants as dv

    layout = sc.best_layout(frags)
    check(layout["smem_bytes"] == 0 and layout["blocks_per_sm"] >= 4,
          f"encode_best kernel: {layout}")
    fns = {
        "v1": lambda: dv.decode_variant(comp_u8, block_lens, BLOCK, "v1"),
        "decode": lambda: sc.decode_blocks_bytes(comp_u8, block_lens, BLOCK),
        "encode_best": lambda: sc._encode_best(frags, lengths, cands),
    }
    turns = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            turns[k].append(cuda_ms(fns[k]))
    print(json.dumps({"card": card, "encode_best_layout": layout,
                      "ms_per_512_in_turns": turns}))
    return layout, turns


def variant_call(dv, name: str):
    """The wrapper of one ablation variant as (comp, lens, out_cap) -> triple."""
    if name in ("v2", "v3", "v4"):
        return getattr(dv, f"decode_{name}")
    return lambda comp, lens, out_cap: dv.decode_variant(comp, lens, out_cap, name)


def phase_ablation(torch, card, decode_streams, frags, comp_u8, block_lens):
    """Phase 7, the ablation path. Returns (max_abs_err per wrapper, launches
    on the path, ms per wrapper at the codec's row width, plain ms per
    wrapper on one row, each wrapper's layouts, ptxas figures and ms per
    form for the kernels line)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_cases import corrupt_streams as more_corrupt
    from torch_cases import pack_streams, walk_streams

    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import decode_variants as dv
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    dev = torch.device("cuda")
    # 1. each variant against its plain version: phase 2's rows (corrupt
    # blocks and encoded 64 KiB rows) and short offsets, overlapping copies,
    # a 4-byte offset, long literals and more malformed blocks; word rows
    # (the ring) and the same rows 1 byte into a buffer (the byte loader).
    streams = decode_streams + walk_streams() + more_corrupt()
    comp, clens = pack_streams(streams, 68608)
    c_h, l_h = torch.from_numpy(comp.astype(np.uint8)), torch.from_numpy(clens)
    c_d, l_d = c_h.to(dev), l_h.to(dev)
    c_buf = torch.zeros(c_d.numel() + 1, dtype=torch.uint8, device=dev)
    c_buf[1:].copy_(c_d.reshape(-1))
    c_odd = c_buf[1:].view(c_d.shape)
    errs = {}
    checked = dv.decode_variant_plain(c_h, l_h, BLOCK, "v1")[2].numpy() == 0
    for name in VARIANTS:
        want = [x.numpy() for x in dv.decode_variant_plain(c_h, l_h, BLOCK, name)]
        rows = np.arange(len(streams))
        if name == "v1nock":  # trusted input only: the rows the checked walk accepts
            rows = rows[checked]
        for rows_d in (c_d, c_odd):
            got = [x.cpu().numpy() for x in variant_call(dv, name)(rows_d, l_d, BLOCK)]
            torch.cuda.synchronize()
            pairs = [(got[1][rows], want[1][rows]), (got[2][rows], want[2][rows])]
            if name != "v1nocp":
                pairs += [(got[0][i, : want[1][i]], want[0][i, : want[1][i]]) for i in rows]
            err = max_abs_err(pairs)
            check(err == 0, f"variant {name} differs from its plain version "
                            f"({'1 byte into a buffer' if rows_d is c_odd else 'word rows'})")
            counter = dv.VARIANTS[name][1]
            errs[counter] = max(errs.get(counter, 0), err)
        if name == "v2":
            seen = set(want[2].tolist())
            check({0, 1, 2, 4, 8} <= seen, f"corrupt rows give error words {sorted(seen)}")
            check(not want[1][want[2] != 0].any(), "out_len must be 0 on any error")
        print(f"variant {name} == plain on {len(rows)} rows, word rows and 1 byte into a "
              f"buffer, max_abs_err {errs[dv.VARIANTS[name][1]]}")
    # Their layout (K1's): only the output image in shared memory, three
    # blocks of two warps an SM at out_cap 65,536 in every form, the ring on
    # word rows; every instantiation's walk in registers.
    layouts = {name: dv.decode_variant_layout(comp_u8, BLOCK, name) for name in VARIANTS}
    layouts["v1_unaligned"] = dv.decode_variant_layout(c_odd, BLOCK, "v1")
    ptxas = ptxas_figures(_build.BUILD_LOG.get("decode_variants", ""), "decode_variant_kernel")
    print(json.dumps({"card": card, "decode_variant_layouts": layouts,
                      "decode_variant_ptxas": ptxas}))
    for name, lay in layouts.items():
        form = name.split("_")[0]
        # The byte loader's kernel keeps no input ring: 1 KiB less.
        smem = dv._smem_bytes(dv.VARIANTS[form][0], BLOCK) - (1024 if "unaligned" in name else 0)
        check(lay == {"blocks_per_sm": 3, "smem_bytes": smem, "threads": 64,
                      "loader": "bytes" if "unaligned" in name else "ring"},
              f"{name}: {lay} at out_cap {BLOCK}")
    # Four forms of the walk (checks and unc 0, 1, 2; unc 2 without checks),
    # each with both loaders.
    check(len(ptxas) == 8, f"ptxas figures for the 8 decode_variant kernels: {ptxas}")
    for fig in ptxas:
        check(all(fig.get(k) == 0 for k in ("stack", "spill_stores", "spill_loads")),
              f"decode_variant kernel stack frame or spills: {fig}")

    # 2. the path: the encode kernel's 512 blocks through the production
    # decode kernel and every variant.
    torch.cuda.synchronize()
    _build.reset_launches()
    k1_out, k1_lens, k1_errs = sc.decode_blocks_bytes(comp_u8, block_lens, BLOCK)
    results = {name: variant_call(dv, name)(comp_u8, block_lens, BLOCK) for name in VARIANTS}
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"ablation path launches: {launches}")
    for k in PATHS["ablation"]:
        check(launches.get(k, 0) > 0, f"kernel {k} did not launch on the ablation path")
    check(launches["decode_variant"] == 3, "decode_variant runs as v1, v1nock and v1nocp")
    check(bool((k1_errs == 0).all()) and bool((k1_out == frags).all()), "production decode")
    for name, (out, out_lens, verrs) in results.items():
        check(bool((verrs == 0).all()), f"variant {name}: errors on the main path")
        check(bool((out_lens == BLOCK).all()), f"variant {name}: lengths on the main path")
        if name != "v1nocp":
            check(bool((out == frags).all()), f"variant {name}: rows differ from the input")
            check(bool((out == k1_out).all()), f"variant {name}: rows differ from decode's")
    print(f"ablation: {B} x {BLOCK} B decoded exactly by the production kernel and 5 full "
          "variants; the walk-only variant agrees on lengths and errors")

    # 3. timings at the codec's row width and at the tight one (the longest
    # block rounded up to 1 KiB).
    tight = comp_u8[:, : -(-(int(block_lens.max()) + 8) // 1024) * 1024].contiguous()
    times = {}
    for width, rows_d in (("codec_width", comp_u8), ("tight_width", tight)):
        t = {"row_bytes": rows_d.shape[1],
             "v0": cuda_ms(lambda: sc.decode_blocks_bytes(rows_d, block_lens, BLOCK))}
        for name in VARIANTS:
            fn = variant_call(dv, name)
            t[name] = cuda_ms(lambda: fn(rows_d, block_lens, BLOCK))
            t[name + "_layout"] = dv.decode_variant_layout(rows_d, BLOCK, name)
        times[width] = t
    print(json.dumps({"card": card, "ablation_ms_per_512_blocks": times}))
    ms = {"decode_v2": times["codec_width"]["v2"], "decode_v4": times["codec_width"]["v4"],
          "decode_v3": times["codec_width"]["v3"], "decode_variant": times["codec_width"]["v1"]}
    c1, cl1 = comp_u8[:1].cpu(), block_lens[:1].cpu()
    plain = {dv.VARIANTS[name][1]: host_ms(lambda: dv.decode_variant_plain(c1, cl1, BLOCK, name))
             for name in ("v2", "v4", "v3", "v1")}
    extra = {}
    for name in VARIANTS:
        counter = dv.VARIANTS[name][1]
        row = extra.setdefault(counter, {"layout": {"ptxas": ptxas}, "ms_by_form": {}})
        row["layout"][name] = layouts[name]
        row["ms_by_form"][name] = {w: times[w][name] for w in times}
    return errs, launches, ms, plain, extra


SCAN_FACADE = """
import json, sys
import numpy as np
import torch
import snappier_tpu_torch as st
from snappier_tpu_torch.models.codec import default_kernel
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.runtime import native
raw = np.fromfile(sys.argv[1], np.uint8).tobytes()
assert default_kernel() == "scan"
comp = st.compress(raw)
back = st.decompress(comp)
native_back = st.decompress(native.compress(raw))
framed = st.stream_compress(raw)
unframed = st.stream_decompress(framed)
torch.cuda.synchronize()
print(json.dumps({"ok": back == raw and native_back == raw and unframed == raw
                  and native.decompress(comp) == raw and native.stream_decompress(framed) == raw,
                  "bytes": len(raw), "compressed": len(comp), "framed": len(framed),
                  "launches": dict(_build.LAUNCHES)}))
"""


def phase_scan(torch, card, data, frags, lengths, comp_u8, block_lens, greedy_lens, k3_crcs):
    """Phase 7, the scan path. Returns the launches inside the scan calls
    (none, or the phase fails) and the scan codec's bodies and lengths."""
    import tempfile

    from snappier_tpu_torch import SnappyCodec
    from snappier_tpu_torch.format import oracle
    from snappier_tpu_torch.format.crc32c import crc32c, mask_crc
    from snappier_tpu_torch.format.varint import write_varint
    from snappier_tpu_torch.ops.crc32c import crc32c_blocks_scan
    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc
    from snappier_tpu_torch.ops.decode import decode_blocks_scan

    dev = torch.device("cuda")
    codec = SnappyCodec(kernel="scan", with_crc=True)
    pre = torch.tensor([0x80, 0x80, 0x04], dtype=torch.uint8, device=dev).expand(B, 3)
    torch.cuda.synchronize()
    _build.reset_launches()
    bodies, body_lens, crcs = codec.compress_batch(frags, lengths)
    blocks = torch.cat([pre, bodies.to(torch.uint8)], dim=1)
    blocks = torch.nn.functional.pad(blocks, (0, (-blocks.shape[1]) % 1024)).contiguous()
    outs, out_lens, derrs = codec.decompress_batch(blocks, body_lens + 3, out_cap=BLOCK)
    framed, flens = codec.frame_batch(frags, lengths)
    _, _, _, ok = codec.roundtrip_step(frags, lengths)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(not launches, f"the scan calls launched CUDA kernels: {launches}")
    check(bool((derrs == 0).all()) and bool((out_lens == BLOCK).all()), "scan decode verdicts")
    check(bool((outs == frags.to(torch.int32)).all()), "scan round trip differs")
    check(bool(ok), "scan roundtrip_step not ok")

    # Cross-engine: the decode kernel and the oracle on the scan bodies, the
    # scan decoder on the encode kernel's bodies.
    k1_out, k1_lens, k1_errs = sc.decode_blocks_bytes(blocks, body_lens + 3, BLOCK)
    check(bool((k1_errs == 0).all()) and bool((k1_out == frags).all()),
          "the decode kernel on the scan bodies")
    s_out, s_lens, s_errs = decode_blocks_scan(comp_u8, block_lens, BLOCK)
    check(bool((s_errs == 0).all()) and bool((s_out == frags.to(torch.int32)).all()),
          "the scan decoder on the encode kernel's bodies")
    bl = body_lens.cpu().numpy()
    body_bytes = bodies.to(torch.uint8).cpu().numpy()
    crc_h = crcs.cpu().numpy().view(np.uint32)
    check(bool((crcs == k3_crcs).all()), "scan CRCs differ from the CRC32C kernel's")
    for i in np.linspace(0, B - 1, 6).astype(int):
        check(int(crc_h[i]) == crc32c(data[i]), f"scan CRC of row {i}")
        blk = write_varint(BLOCK) + body_bytes[i, : bl[i]].tobytes()
        check(oracle.decompress(blk) == data[i].tobytes(), f"oracle decode of scan row {i}")
    check(int(bl.sum()) <= int(greedy_lens.sum()),
          f"scan bodies ({int(bl.sum())} B) larger than greedy ({int(greedy_lens.sum())} B)")
    fl, fr = flens.cpu().numpy(), framed.cpu().numpy()
    for i in (0, B - 1):
        row = fr[i, : fl[i]]
        check(row[0] == 0 and int.from_bytes(row[1:4].tobytes(), "little") == fl[i] - 4
              and int.from_bytes(row[4:8].tobytes(), "little") == mask_crc(crc32c(data[i]))
              and oracle.decompress(row[8:].tobytes()) == data[i].tobytes(),
              f"scan frame_batch row {i}")
    print(f"scan path: {B} x {BLOCK} B round trip exact with no CUDA kernel launched; "
          f"{int(bl.sum())} B against the greedy encoder's {int(greedy_lens.sum())} B; cross-decodes "
          "with the decode kernel, the encode kernel and the oracle; CRCs equal the CRC32C "
          "kernel's and the host's; frame_batch and roundtrip_step ok")

    # Corrupt rows: each failure by its own bit, the card as the CPU.
    bad = corrupt_streams()
    comp = np.zeros((len(bad), 1024), np.uint8)
    clens = np.array([len(x) for x in bad], np.int32)
    for i, x in enumerate(bad):
        comp[i, : len(x)] = np.frombuffer(x, np.uint8)
    on_card = decode_blocks_scan(torch.from_numpy(comp).to(dev), torch.from_numpy(clens).to(dev),
                                 BLOCK)
    on_cpu = decode_blocks_scan(torch.from_numpy(comp), torch.from_numpy(clens), BLOCK)
    for a, b in zip(on_card, on_cpu):
        check(bool((a.cpu() == b).all()), "scan decode differs between the card and the CPU")
    words = on_cpu[2].tolist()
    check(words[0] == 8 and words[2] & 1 and words[3] == 1 and words[4] == 2 and words[5] == 2
          and words[6] == 4, f"scan error words {words}")
    print(f"scan decoder on corrupt rows: error words {words}, card == CPU")

    # The facade and the streams with SNAPPIER_KERNEL=scan, as a user sets it.
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        f.write(data[:64].tobytes())  # 4 MiB
        f.flush()
        env = dict(os.environ, SNAPPIER_KERNEL="scan")
        r = subprocess.run([sys.executable, "-c", SCAN_FACADE, f.name], env=env, text=True,
                           capture_output=True, timeout=300,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
    check(r.returncode == 0, f"facade under SNAPPIER_KERNEL=scan failed:\n{r.stdout}{r.stderr}")
    facade = json.loads(r.stdout.strip().splitlines()[-1])
    check(facade["ok"] and not facade["launches"], f"facade under scan: {facade}")
    print(f"SNAPPIER_KERNEL=scan in a subprocess: compress / decompress and the stream "
          f"one-shots on {facade['bytes']} B exact, no CUDA kernel launched: {facade}")

    # Timings and peak memory.
    no_crc = SnappyCodec(kernel="scan", with_crc=False)
    peak = {}
    for what, fn in (("compress", lambda: no_crc.compress_batch(frags, lengths)),
                     ("decompress", lambda: codec.decompress_batch(blocks, body_lens + 3))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak[what] = torch.cuda.max_memory_allocated() - before
    print(json.dumps({
        "card": card, "scan_compress_ms": cuda_ms(lambda: no_crc.compress_batch(frags, lengths),
                                                  iters=2),
        "scan_compress_with_crc_ms": cuda_ms(lambda: codec.compress_batch(frags, lengths), iters=2),
        "scan_decompress_ms": cuda_ms(lambda: codec.decompress_batch(blocks, body_lens + 3),
                                      iters=2),
        "scan_crc_ms": cuda_ms(lambda: crc32c_blocks_scan(frags, lengths), iters=2),
        "scan_peak_bytes_above_inputs": peak, "scan_ratio": float(bl.sum()) / (B * BLOCK),
        "blocks": B,
    }))
    return launches, bodies, body_lens


def timed(module, name: str, sink: dict):
    """Replace ``module.name`` with a wrapper that adds its host time (the
    device drained before and after) to ``sink[name]``; returns the original."""
    import torch

    saved = getattr(module, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved(*args, **kwargs)
        torch.cuda.synchronize()
        sink[name] = sink.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    setattr(module, name, wrapper)
    return saved


def phase_sharded(torch, card, data, frags, lengths, k2_bodies, k2_lens, scan_bodies, scan_lens):
    """Phase 8, the sharded paths. Returns the launches of the scalar-engine
    path and of the scan-engine path (none, or the phase fails)."""
    import tempfile

    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_cases import check_union, run_workers, worker_module

    import snappier_tpu_torch as st
    from snappier_tpu_torch import SnappyCodec, graft_entry
    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.parallel import distributed as pdist
    from snappier_tpu_torch.parallel import make_mesh, sharded_roundtrip_step
    from snappier_tpu_torch.parallel import mesh as pmesh
    from snappier_tpu_torch.runtime import block, native

    mesh = make_mesh(["cuda:0"] * SHARDS)
    raw32 = data.tobytes()
    raw256 = stream_bytes(STREAM_CHUNKS) * 2
    n_frag = len(raw256) // BLOCK
    per = B // SHARDS

    def step(kernel, ref_bodies, ref_lens):
        bodies, body_lens, offsets, ok = sharded_roundtrip_step(frags, lengths, mesh=mesh,
                                                                kernel=kernel)
        torch.cuda.synchronize()
        check(bool(ok), f"sharded round trip not ok ({kernel})")
        check([r for r, _ in bodies.addressable_shards] == [
            range(s * per, (s + 1) * per) for s in range(SHARDS)], "shard row ranges")
        check(bool((body_lens == ref_lens).all()), f"sharded body_lens differ ({kernel})")
        check(offsets.dtype == torch.int64 and bool(
            (offsets == torch.cumsum(ref_lens.long(), 0) - ref_lens).all()),
            f"offsets are not the running sum of the lengths ({kernel})")
        got = bodies.gather()
        keep = torch.arange(got.shape[1], device=got.device)[None, :] < body_lens[:, None]
        check(bool(((got == ref_bodies[:, : got.shape[1]].to(torch.uint8)) | ~keep).all()),
              f"sharded bodies differ from the unsharded codec's ({kernel})")
        return int(body_lens.sum())

    def corpus(raw, kernel):
        payload, meta = pdist.compress_corpus_sharded(raw, mesh=mesh, kernel=kernel)
        plain, dmeta = pdist.decompress_corpus_sharded(payload, mesh=mesh, kernel=kernel)
        n = len(raw) // BLOCK
        check(plain == raw, f"sharded corpus round trip differs ({kernel})")
        check(meta["local_blocks"] == list(range(n)) and dmeta["local_fragments"] == list(
            range(n)), f"local sets incomplete ({kernel})")
        check(not dmeta.get("window_crossing_fallback"), "window-crossing fallback taken")
        check(native.decompress(payload) == raw, f"native decode of the sharded stream ({kernel})")
        off, bl_ = meta["block_offsets"], meta["block_lengths"]
        check(bool((np.diff(off) == bl_[:-1]).all()) and int(off[-1] + bl_[-1]) == len(payload),
              "block offsets of the sharded stream")
        return payload

    # The scalar-engine path. Neither the host decoder nor the Python
    # prescan may run: every fragment decodes on the card.
    torch.cuda.synchronize()
    _build.reset_launches()
    total = step("scalar", k2_bodies, k2_lens)
    with forbidden(block, "_host_decode"):
        payload256 = corpus(raw256, "scalar")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"sharded path launches: {launches}")
    check(launches == {"encode": 2 * SHARDS, "decode": 2 * SHARDS},
          f"sharded path launches {launches}")
    print(f"sharded step: {SHARDS} shards x {per} x {BLOCK} B on one card, ok, {total} B of "
          f"bodies equal to the unsharded codec's; corpus: {len(raw256)} B in {n_frag} fragments "
          f"-> {len(payload256)} B, round trip exact on the mesh and through the native engine")

    # The scan-engine path: tensor code, no kernel.
    _build.reset_launches()
    total = step("scan", scan_bodies, scan_lens)
    payload32 = corpus(raw32, "scan")
    torch.cuda.synchronize()
    scan_launches = dict(_build.LAUNCHES)
    check(not scan_launches, f"the sharded scan calls launched CUDA kernels: {scan_launches}")
    print(f"sharded scan step: ok, {total} B of bodies equal to the unsharded scan codec's; "
          f"corpus: {len(raw32)} B -> {len(payload32)} B, round trip exact, no kernel launched")

    expect_invalid(st, "a sharded stream cut in half", lambda: pdist.decompress_corpus_sharded(
        payload32[: len(payload32) // 2], mesh=mesh, kernel="scalar"))
    bad = bytearray(payload32[: 3 + 4000])
    bad[0:3] = bytes([0x80, 0x80, 0x04])  # claims 65536 bytes, holds fewer
    expect_invalid(st, "a sharded stream that ends short of its claim",
                   lambda: pdist.decompress_corpus_sharded(bytes(bad), mesh=mesh))
    print("corrupt sharded streams raise InvalidDataError")

    # Two processes on the card, joined over loopback (lengths travel as
    # host tensors on a gloo group, payload stays on the card).
    worker = worker_module()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        metas, payloads, plains = run_workers(d, 2, 2, 16, "cuda", "gloo", timeout=300)
        secs = time.perf_counter() - t0
    for meta in metas:
        check(meta["process_count"] == 2 and meta["mesh_size"] == 4 and meta["backend"] == "gloo"
              and meta["device"].startswith("cuda"), f"worker meta {meta}")
        check(meta["launches"].get("encode", 0) > 0 and meta["launches"].get("decode", 0) > 0,
              f"a worker launched no kernel: {meta['launches']}")
    stream = check_union(metas, payloads,
                         ("block_lengths", "block_offsets", "local_blocks")).tobytes()
    check(native.decompress(stream) == worker.corpus(16), "the workers' union does not decode")
    single, _ = pdist.compress_corpus_sharded(worker.corpus(16), mesh=mesh, kernel="scalar")
    check(stream == single, "the workers' union differs from the single-process stream")
    plain = check_union(metas, plains,
                        ("fragment_lengths", "fragment_offsets", "local_fragments"))
    check(plain.tobytes() == worker.stream_case(3 * 2 + 2)[0], "the workers' decoded union")
    print(f"two worker processes on the card (gloo over loopback, 2 shards each) in {secs:.1f} s: "
          f"identical maps, local sets partition 16 blocks, union exact: {metas[0]['launches']}")

    if dist.is_nccl_available():
        with tempfile.TemporaryDirectory() as d:
            (meta,), (part,), _ = run_workers(d, 1, SHARDS, 16, "cuda", "nccl", timeout=300)
        check(meta["backend"] == "nccl" and part.tobytes() == single,
              f"the NCCL run differs: {meta}")
        print("NCCL: one process on an NCCL group, lengths gathered as a CUDA tensor, stream "
              "equal to the gloo run's")
    else:
        print("NCCL: this PyTorch build has no NCCL; the NCCL run was not made")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        graft_entry.dryrun_multichip(SHARDS)
    line = out.getvalue().strip().splitlines()[-1]
    check(line.startswith("dryrun_multichip ok: mesh={'blocks': 4}"), line)
    print(line)
    fn, args = graft_entry.entry()
    e_bodies, e_lens, e_crcs = fn(*args)
    check(args[0].is_cuda and tuple(e_lens.shape) == (4,) and bool((e_lens > 0).all()),
          "graft_entry.entry() on the card")

    # Timings: the 4-shard step against the unsharded one, and where a
    # sharded corpus call's host time goes.
    codec = SnappyCodec(with_crc=False)
    t_step = {}
    for _ in range(2):  # unsharded, sharded, sharded, unsharded: one card, in turns
        for name, fn in (("unsharded", lambda: codec.roundtrip_step(frags, lengths)),
                         ("sharded", lambda: sharded_roundtrip_step(
                             frags, lengths, mesh=mesh, kernel="scalar")),
                         ("sharded", lambda: sharded_roundtrip_step(
                             frags, lengths, mesh=mesh, kernel="scalar")),
                         ("unsharded", lambda: codec.roundtrip_step(frags, lengths))):
            t_step.setdefault(name + "_cuda_ms", []).append(cuda_ms(fn, iters=3, passes=2))

            def whole(fn=fn):
                fn()
                torch.cuda.synchronize()

            t_step.setdefault(name + "_host_ms", []).append(best_host_ms(whole, passes=2))
    parts: dict = {}
    saved = [(pmesh, "_replicated_lengths", timed(pmesh, "_replicated_lengths", parts)),
             (pdist, "_scatter_rows", timed(pdist, "_scatter_rows", parts)),
             (pdist, "sharded_compress", timed(pdist, "sharded_compress", parts)),
             (pdist, "sharded_decompress", timed(pdist, "sharded_decompress", parts))]
    try:
        t0 = time.perf_counter()
        payload, _ = pdist.compress_corpus_sharded(raw256, mesh=mesh, kernel="scalar")
        t_comp = (time.perf_counter() - t0) * 1e3
        comp_parts = dict(parts)
        parts.clear()
        t0 = time.perf_counter()
        pdist.decompress_corpus_sharded(payload, mesh=mesh, kernel="scalar")
        t_dec = (time.perf_counter() - t0) * 1e3
        dec_parts = dict(parts)
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    print(json.dumps({
        "card": card, "shards": SHARDS, "blocks": B,
        "roundtrip_step_ms": {k: min(v) for k, v in t_step.items()}, "all_runs_ms": t_step,
        "corpus_bytes": len(raw256), "compress_corpus_sharded_host_ms": t_comp,
        "compress_parts_host_ms": comp_parts, "decompress_corpus_sharded_host_ms": t_dec,
        "decompress_parts_host_ms": dec_parts,
    }))
    return launches, scan_launches


def encode_cases(ev) -> list:
    """Phase 8's encode-ablation calls as (wrapper, name, argument): every
    named ``encode_variant`` tuple, the empty one and one that runs the
    walk whose mask is a run-time value, every ``encode_r4`` name."""
    cases = [("encode_variant", name, flags) for name, flags in ev.VARIANT_FLAGS.items()]
    cases += [("encode_variant", "none", ()),
              ("encode_variant", "probe8,st1,hb9", ("probe8", "st1", "hb9"))]
    return cases + [("encode_r4", name, name) for name in ev.R4_VARIANTS]


def phase_encode_ablation(torch, card, decode_streams, frags, lengths, k2_lens, comp_u8,
                          block_lens):
    """Phase 8, the encode-ablation path. Returns (max_abs_err per wrapper,
    launches on the path, ms per wrapper, plain ms per wrapper on one row,
    bytes of bodies that the timed variant of each encode wrapper wrote, the
    encode wrappers' layouts and ptxas figures)."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    sys.path.insert(0, os.path.join(root, "tools"))
    from torch_cases import corrupt_streams as more_corrupt
    from torch_cases import empty_literal_streams
    from torch_cases import encode_rows as small_rows
    from torch_cases import PIPE_CASES as pipe_cases
    from torch_cases import pack_streams, walk_streams
    from torch_perf_probe import tag_mix

    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import decode_variants as dv
    from snappier_tpu_torch.ops.cuda import encode_variants as ev
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    dev = torch.device("cuda")
    errs = {}
    PIPE_CASES = dict(pipe_cases)  # name -> decode_pipe2's arguments ("pipe": decode_pipe)
    enc_cases = encode_cases(ev)
    wrappers = {"encode_variant": (ev.encode_variant, ev.encode_variant_plain),
                "encode_r4": (ev.encode_r4, ev.encode_r4_plain)}

    def emits(counter, arg):
        return "noemit" not in arg if counter == "encode_variant" else arg not in ev.R4_NO_BYTES

    # 1. each kernel against its plain version. Encoders: markup, random,
    # all-zero and period-1..7 rows of 4 KiB, a ragged tail, rows of 1, 15,
    # 16, 17 and 40 bytes and an empty row, with garbage past each length;
    # then at the main path's row width: three of its 65,536-byte fragments,
    # markup at full and ragged length, random bytes, a period-2 pattern, a
    # 15-byte row and 20,000 random bytes repeated (matches at offsets that
    # need a copy-2 tag, table positions across the whole row).
    f_small, l_small = small_rows(4096)
    f_small = np.concatenate([f_small, f_small[:1]]).astype(np.uint8)
    l_small = np.concatenate([l_small, [0]]).astype(np.int32)
    f_wide, l_wide = small_rows(BLOCK)
    far = np.tile(np.random.default_rng(23).integers(0, 256, 20000, dtype=np.uint8), 4)[:BLOCK]
    f_wide = np.concatenate([frags[[0, B // 2, B - 1]].cpu().numpy(),
                             f_wide[[0, 1, 2, 5, 12]].astype(np.uint8), far[None]])
    l_wide = np.concatenate([[BLOCK] * 3, l_wide[[0, 1, 2, 5, 12]], [BLOCK]]).astype(np.int32)
    # The rows of 4 KiB also 1 byte into a larger buffer (the byte loader).
    f_odd = torch.zeros(f_small.size + 1, dtype=torch.uint8, device=dev)
    f_odd = f_odd[1:].view(f_small.shape)
    f_odd.copy_(torch.from_numpy(f_small).to(dev))
    t0 = time.perf_counter()
    plain_of = {}  # (row width, name) -> the plain version's bodies and lengths
    for f_rows, l_rows, view in ((f_small, l_small, None), (f_small, l_small, f_odd),
                                 (f_wide, l_wide, None)):
        fs_h, ls_h = torch.from_numpy(f_rows), torch.from_numpy(l_rows)
        fs_d, ls_d = fs_h.to(dev) if view is None else view, ls_h.to(dev)
        for counter, name, arg in enc_cases:
            fn, plain = wrappers[counter]
            got_b, got_l = (x.cpu().numpy() for x in fn(fs_d, ls_d, arg))
            torch.cuda.synchronize()
            key = (f_rows.shape[1], name)
            if key not in plain_of:
                plain_of[key] = [x.numpy() for x in plain(fs_h, ls_h, arg)]
            want_b, want_l = plain_of[key]
            pairs = [(got_l, want_l)]
            if emits(counter, arg):
                pairs += [(got_b[i, :n], want_b[i, :n]) for i, n in enumerate(want_l)]
            err = max_abs_err(pairs)
            check(err == 0, f"{counter} {name} differs from its plain version on rows of "
                            f"{f_rows.shape[1]} B{'' if view is None else ' 1 byte in'}")
            errs[counter] = max(errs.get(counter, 0), err)
    print(f"encode_variant ({len(ev.VARIANT_FLAGS)} named tuples and 2 others) and encode_r4 "
          f"({len(ev.R4_VARIANTS)} names) == plain on {len(l_small)} rows of 4096 B (aligned and "
          f"1 byte into a buffer) and {len(l_wide)} rows of {BLOCK} B, max_abs_err 0 "
          f"({time.perf_counter() - t0:.1f} s)")
    # Their layout (K2's): the match table alone in shared memory, one warp a
    # fragment, the word loader on aligned rows; T8 at 15 hash bits at least
    # three walks an SM, T5 at its 14 at least four; every instantiation's
    # walk in registers (no stack frame, no spill).
    layouts = {
        "encode_variant": {"e3": ev.encode_variant_layout(frags, ev.VARIANT_FLAGS["e3"]),
                           "hb9": ev.encode_variant_layout(frags, ("probe8", "st1", "hb9")),
                           "e3_unaligned": ev.encode_variant_layout(f_odd, ev.VARIANT_FLAGS["e3"])},
        "encode_r4": {"encpre": ev.encode_r4_layout(frags, "encpre"),
                      "encpre_unaligned": ev.encode_r4_layout(f_odd, "encpre")},
    }
    ptxas = {"encode_variant": ptxas_figures(_build.BUILD_LOG.get("encode_variants", ""),
                                             "encode_variant_kernel"),
             "encode_r4": ptxas_figures(_build.BUILD_LOG.get("encode_r4", ""),
                                        "encode_variant_kernel")}
    print(json.dumps({"card": card, "encode_ablation_layouts": layouts,
                      "encode_ablation_ptxas": ptxas}))
    t5, t8 = layouts["encode_variant"], layouts["encode_r4"]
    check(t8["encpre"]["blocks_per_sm"] >= 3 and t8["encpre"]["smem_bytes"] == 2 << 15,
          f"encode_r4: {t8['encpre']} at 15 hash bits")
    check(t5["e3"]["blocks_per_sm"] >= 4 and t5["e3"]["smem_bytes"] == 2 << 14,
          f"encode_variant: {t5['e3']} at 14 hash bits")
    check(t5["hb9"]["smem_bytes"] == 2 << 9, f"encode_variant: {t5['hb9']} at 9 hash bits")
    check(all(lay["loader"] == ("bytes" if k.endswith("unaligned") else "words")
              for t in (t5, t8) for k, lay in t.items()), "the ablation kernels' loaders")
    # 15 walks (14 named and the run-time one) and 14, each with both loaders.
    for what, count in (("encode_variant", 30), ("encode_r4", 28)):
        figs = ptxas[what]
        check(len(figs) == count, f"ptxas figures for the {count} {what} kernels: {figs}")
        for fig in figs:
            check(all(fig.get(k) == 0 for k in ("stack", "spill_stores", "spill_loads")),
                  f"{what} kernel stack frame or spills: {fig}")
    # Decoders: phase 2's rows (corrupt blocks and encoded 64 KiB rows), short
    # offsets, overlapping copies, long literals, more malformed blocks and
    # blocks with literals of no bytes (decode_pipe2 takes them), as word rows
    # through the ring and 1 byte into a buffer through the byte loader.
    empty = empty_literal_streams()
    streams = decode_streams + walk_streams() + more_corrupt() + empty
    comp, clens = pack_streams(streams, 68608)
    c_h, l_h = torch.from_numpy(comp.astype(np.uint8)), torch.from_numpy(clens)
    c_d, l_d = c_h.to(dev), l_h.to(dev)
    c_buf = torch.zeros(c_d.numel() + 1, dtype=torch.uint8, device=dev)
    c_buf[1:].copy_(c_d.reshape(-1))
    c_odd = c_buf[1:].view(c_d.shape)
    plain_rows = {fold: [x.numpy() for x in dv.decode_pipe_plain(c_h, l_h, BLOCK, fold)]
                  for fold in (False, True)}
    k1_rows = [x.cpu().numpy() for x in sc.decode_blocks_bytes(c_d, l_d, BLOCK)]

    def pipe_call(name, rows, lens):
        if name == "pipe":
            return dv.decode_pipe(rows, lens, BLOCK)
        return dv.decode_pipe2(rows, lens, BLOCK, **PIPE_CASES[name])

    for name, kw in PIPE_CASES.items():
        want = plain_rows[name != "pipe"]
        for rows_d in (c_d, c_odd):
            got = [x.cpu().numpy() for x in pipe_call(name, rows_d, l_d)]
            torch.cuda.synchronize()
            pairs = [(got[1], want[1]), (got[2], want[2])]
            if kw.get("emit", True):
                pairs += [(got[0][i, :n], want[0][i, :n]) for i, n in enumerate(want[1])]
            err = max_abs_err(pairs)
            check(err == 0, f"{name} differs from its plain version "
                            f"({'1 byte into a buffer' if rows_d is c_odd else 'word rows'})")
            counter = "decode_pipe" if name == "pipe" else "decode_pipe2"
            errs[counter] = max(errs.get(counter, 0), err)
    seen = set(plain_rows[True][2].tolist())
    check(seen == {0, 4, 7, 8}, f"corrupt rows give error words {sorted(seen)}")
    check(all((plain_rows[False][k] == k1_rows[k]).all() for k in (1, 2)),
          "decode_pipe's verdicts differ from the decode kernel's")
    check(plain_rows[False][2][-len(empty):].tolist() == [7] * len(empty)
          and not plain_rows[True][2][-len(empty):].any(), "the literals of no bytes")
    print(f"decode_pipe and decode_pipe2 ({len(PIPE_CASES) - 1} forms) == plain on "
          f"{len(streams)} rows ({len(empty)} with literals of no bytes), word rows and 1 byte "
          "into a buffer; decode_pipe's verdicts == the decode kernel's; max_abs_err 0")
    # Their layout (K1's): only the output image in shared memory, three
    # blocks of two warps an SM at out_cap 65,536 in every form, the ring on
    # word rows; every instantiation's walk in registers.
    pipe_forms = {name: dict(fold=name != "pipe", **kw) for name, kw in PIPE_CASES.items()}
    pipe_layouts = {name: dv.decode_pipe_layout(comp_u8, BLOCK, **kw)
                    for name, kw in pipe_forms.items()}
    pipe_layouts["pipe2unc2_unaligned"] = dv.decode_pipe_layout(c_odd, BLOCK,
                                                                **pipe_forms["pipe2unc2"])
    pipe_ptxas = ptxas_figures(_build.BUILD_LOG.get("decode_pipe", ""), "decode_pipe_kernel")
    print(json.dumps({"card": card, "decode_pipe_layouts": pipe_layouts,
                      "decode_pipe_ptxas": pipe_ptxas}))
    for name, lay in pipe_layouts.items():
        unc = pipe_forms[name.split("_")[0]].get("unc", 0)
        # The byte loader's kernel keeps no input ring: 1 KiB less.
        smem = dv._pipe_smem_bytes(BLOCK, unc) - (1024 if "unaligned" in name else 0)
        check(lay == {"blocks_per_sm": 3, "smem_bytes": smem, "threads": 64,
                      "loader": "bytes" if "unaligned" in name else "ring"},
              f"{name}: {lay} at out_cap {BLOCK}")
    # decode_pipe and twelve decode_pipe2 forms (unroll 1-4 x unc 0-2), each
    # with both loaders.
    check(len(pipe_ptxas) == 26, f"ptxas figures for the 26 decode_pipe kernels: {pipe_ptxas}")
    for fig in pipe_ptxas:
        check(all(fig.get(k) == 0 for k in ("stack", "spill_stores", "spill_loads")),
              f"decode_pipe kernel stack frame or spills: {fig}")

    # 2. the path: the 512 fragments through the encode kernel and every
    # named encode variant, the encode kernel's 512 blocks through the decode
    # kernel and every pipelined form.
    pre = torch.tensor([0x80, 0x80, 0x04], dtype=torch.uint8, device=dev).expand(B, 3)
    k2_lens_sum = int(k2_lens.sum())
    torch.cuda.synchronize()
    _build.reset_launches()
    e_bodies, e_lens = sc.encode_blocks_bytes(frags, lengths)
    check(bool((e_lens == k2_lens).all()), "the encode kernel's lengths changed")
    k1_out, _, k1_errs = sc.decode_blocks_bytes(comp_u8, block_lens, BLOCK)
    check(bool((k1_errs == 0).all()) and bool((k1_out == frags).all()), "production decode")
    sizes, identical = {}, []
    for counter, name, arg in enc_cases:
        bodies, body_lens = wrappers[counter][0](frags, lengths, arg)
        sizes[name] = int(body_lens.sum())
        if not emits(counter, arg):
            continue
        if name in ev.R4_PRODUCTION_BYTES:
            keep = torch.arange(bodies.shape[1], device=dev)[None, :] < body_lens[:, None]
            check(bool((body_lens == k2_lens).all()) and bool(
                ((bodies == e_bodies[:, : bodies.shape[1]]) | ~keep).all()),
                f"{name}: bytes differ from the encode kernel's")
            identical.append(name)
            continue
        rows = torch.cat([pre, bodies], dim=1)
        out, out_lens, derrs = sc.decode_blocks_bytes(rows, body_lens + 3, BLOCK)
        check(bool((derrs == 0).all()) and bool((out_lens == BLOCK).all())
              and bool((out == frags).all()), f"{name}: does not decode to the input")
    check(sizes["encnoemit"] == sizes["enccopywhen"], "encnoemit counts its walk's lengths")
    check(sizes["encdmaonly"] == B * BLOCK and sizes["edma"] == 0, "the variants without a walk")
    check(all(sizes[k] > 0 and sizes[k] % 2 == 0 for k in ("e4", "e7n", "e6n")),
          "the variants that count matches")
    for name in PIPE_CASES:
        out, out_lens, perrs = pipe_call(name, comp_u8, block_lens)
        check(bool((perrs == 0).all()) and bool((out_lens == BLOCK).all()),
              f"{name}: verdicts on the main path")
        if name != "denoemit":
            check(bool((out == k1_out).all()), f"{name}: rows differ from decode's")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"encode_ablation path launches: {launches}")
    for k in PATHS["encode_ablation"]:
        check(launches.get(k, 0) > 0, f"kernel {k} did not launch on the encode_ablation path")
    check(launches["encode_variant"] == len(ev.VARIANT_FLAGS) + 2
          and launches["encode_r4"] == len(ev.R4_VARIANTS) and launches["decode_pipe"] == 1
          and launches["decode_pipe2"] == len(PIPE_CASES) - 1, f"launch counts {launches}")
    print(f"encode ablation: {B} x {BLOCK} B; {identical} give the encode kernel's bytes, every "
          f"other emitting variant decodes to the input through the decode kernel; "
          f"{len(PIPE_CASES) - 1} pipelined forms give the decode kernel's rows")

    # 3. timings beside the production kernels. Decoders at the codec's row
    # width and at the tight one; ns per tag over the waves of blocks that
    # the card runs at once.
    ntags, _ = tag_mix(comp_u8[0, : int(block_lens[0])].cpu().numpy().tobytes())
    t_enc = {"k2": {"ms": cuda_ms(lambda: sc.encode_blocks_bytes(frags, lengths), iters=3),
                    "size_share": 1.0}}
    for counter, name, arg in enc_cases:
        fn = wrappers[counter][0]
        t_enc[name] = {"ms": cuda_ms(lambda: fn(frags, lengths, arg), iters=3),
                       "size_share": sizes[name] / k2_lens_sum}
    tight = comp_u8[:, : -(-(int(block_lens.max()) + 8) // 1024) * 1024].contiguous()
    t_dec = {}
    for width, rows_d in (("codec_width", comp_u8), ("tight_width", tight)):
        in_flight = {name: 132 * dv.decode_pipe_layout(rows_d, BLOCK, **kw)["blocks_per_sm"]
                     for name, kw in pipe_forms.items()}
        k1_in_flight = 132 * sc.decode_layout(rows_d, BLOCK)["blocks_per_sm"]
        t = {"row_bytes": rows_d.shape[1], "blocks_in_flight": in_flight,
             "k1": cuda_ms(lambda: sc.decode_blocks_bytes(rows_d, block_lens, BLOCK))}
        t["k1_ns_per_tag"] = t["k1"] * 1e6 / -(-B // k1_in_flight) / ntags
        for name in PIPE_CASES:
            t[name] = cuda_ms(lambda: pipe_call(name, rows_d, block_lens))
            t[name + "_ns_per_tag"] = t[name] * 1e6 / -(-B // in_flight[name]) / ntags
        t_dec[width] = t
    print(json.dumps({"card": card, "tags_per_block": ntags,
                      "encode_ablation_per_512_blocks": t_enc,
                      "pipe_ms_per_512_blocks": t_dec}))
    ms = {"encode_variant": t_enc["e3"]["ms"], "encode_r4": t_enc["encpre"]["ms"],
          "decode_pipe": t_dec["codec_width"]["pipe"],
          "decode_pipe2": t_dec["codec_width"]["pipe2u2"]}
    f1, l1 = frags[:1].cpu(), lengths[:1].cpu()
    c1, cl1 = comp_u8[:1].cpu(), block_lens[:1].cpu()
    plain = {
        "encode_variant": host_ms(lambda: ev.encode_variant_plain(f1, l1, ev.VARIANT_FLAGS["e3"])),
        "encode_r4": host_ms(lambda: ev.encode_r4_plain(f1, l1, "encpre")),
        "decode_pipe": host_ms(lambda: dv.decode_pipe_plain(c1, cl1, BLOCK, False)),
        "decode_pipe2": host_ms(lambda: dv.decode_pipe_plain(c1, cl1, BLOCK, True)),
    }
    sizes = {"encode_variant": sizes["e3"], "encode_r4": sizes["encpre"]}
    extra = {k: {"layout": {**layouts[k], "ptxas": ptxas[k]}} for k in ptxas}
    for k, names in (("decode_pipe", ("pipe",)),
                     ("decode_pipe2", [n for n in PIPE_CASES if n != "pipe"])):
        extra[k] = {"layout": {**{n: pipe_layouts[n] for n in names}, "ptxas": pipe_ptxas},
                    "ms_by_form": {w: {n: t_dec[w][n] for n in names} for w in t_dec}}
    return errs, launches, ms, plain, sizes, extra


HYBRID_FORMS = ("v5", "v6", "v7", "v7u")  # v7u: decode_v7(unroll2=True)


def hybrid_call(dh, form: str):
    """The wrapper of one descriptor-driven form as (comp, lens, out_cap) -> triple."""
    if form == "v7u":
        return lambda comp, lens, out_cap: dh.decode_v7(comp, lens, out_cap, unroll2=True)
    return getattr(dh, f"decode_{form}")


def phase_hybrid(torch, card, decode_streams, frags, comp_u8, block_lens):
    """Phase 9, the hybrid path. Returns (max_abs_err per wrapper, launches
    on the path, ms per wrapper at the codec's row width, plain ms per
    wrapper on one row, extra fields of the T14, T16 and T18 rows of the
    kernels line: layouts, the pre-pass kernels, walks and variants)."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    sys.path.insert(0, os.path.join(root, "tools"))
    from torch_cases import corrupt_streams as more_corrupt
    from torch_cases import pack_streams, step_back_streams, walk_streams
    from torch_perf_probe import tag_mix

    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import decode_hybrid as dh
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    dev = torch.device("cuda")
    errs = {}
    pre_errs = {}
    # 1. each form against its plain version, the pre-passes on the card
    # against the CPU's: phase 2's rows (corrupt blocks and encoded rows of
    # up to 64 KiB), short offsets, overlapping copies, long literals, three
    # 64 KiB oracle blocks, more malformed blocks, the step-back blocks
    # (decode_v5 steps its output back inside a batch), and 9 of the main
    # path's blocks of 65,536 bytes.
    t0 = time.perf_counter()
    picks = torch.from_numpy(np.linspace(0, B - 1, 9).astype(np.int64)).to(dev)
    main_rows = comp_u8[picks].cpu().numpy()
    main_streams = [main_rows[i, :n].tobytes() for i, n in enumerate(block_lens[picks].tolist())]
    streams = (decode_streams + walk_streams(big=BLOCK) + more_corrupt() + step_back_streams()
               + main_streams)
    comp, clens = pack_streams(streams, 68608)
    c_h, l_h = torch.from_numpy(comp.astype(np.uint8)), torch.from_numpy(clens)
    c_d, l_d = c_h.to(dev), l_h.to(dev)
    k1 = [x.cpu().numpy() for x in sc.decode_blocks_bytes(c_d, l_d, BLOCK)]
    back_rows = [streams.index(x) for x in step_back_streams()]
    n_main = 0

    def differs(got, want):
        pairs = [(got[1], want[1]), (got[2], want[2])]
        return max_abs_err(pairs + [(got[0][i, :n], want[0][i, :n])
                                    for i, n in enumerate(want[1])])

    for base in ("v5", "v6", "v7"):
        pre_h = dh._prepass(c_h, base)
        pre_d = dh._prepass(c_d, base)
        pre_errs[base] = max_abs_err((a.cpu(), b) for a, b in zip(pre_d, pre_h) if b is not None)
        check(pre_errs[base] == 0, f"pre-pass of {base}: card != CPU")
        want = [x.numpy() for x in dh.walk_plain(c_h, pre_h[0], pre_h[1], l_h, BLOCK, base)]
        forms = [f for f in HYBRID_FORMS if f[:2] == base]
        for form in forms:
            got = [x.cpu().numpy() for x in hybrid_call(dh, form)(c_d, l_d, BLOCK)]
            err = differs(got, want)
            check(err == 0, f"{form} differs from its plain version")
            # K1 refuses v5's step back; elsewhere the verdicts and rows agree.
            same = np.ones(len(streams), bool)
            same[back_rows] = base != "v5"
            check(bool(((got[2] == 0) == (k1[2] == 0))[same].all()),
                  f"{form}: verdicts differ from K1's")
            check(all((got[0][i, :n] == k1[0][i, :n]).all() for i, n in enumerate(k1[1])),
                  f"{form}: rows differ from K1's")
            errs[dh.FORMS[base][1]] = max(errs.get(dh.FORMS[base][1], 0), err)
        if base == "v5":
            got = [x.cpu().numpy() for x in dh.decode_v5_spec(dh.pack_words(c_d), pre_d[0], l_d,
                                                               BLOCK)]
            errs["decode_v5_parts"] = differs(got, want)
            check(errs["decode_v5_parts"] == 0, "decode_v5_spec differs from decode_v5's plain")
        seen = set(want[2].tolist())
        check(seen == ({0, 4, 8} if base == "v7" else {0, 2, 3, 4, 8}),
              f"{base}: corrupt rows give error words {sorted(seen)}")
        check(not want[1][want[2] != 0].any(), "out_len must be 0 on any error")
        back = want[2][back_rows].tolist()
        check(back == ([0, 0, 0] if base == "v5" else [4, 4, 4]),
              f"{base}: the step-back rows give {back}")
        n_main = int((want[1] == BLOCK).sum())
    check(n_main >= 9, f"only {n_main} rows of {BLOCK} B")
    # The pre-passes and the walks on rows that are no word rows (the byte
    # loaders): 3 bytes narrower, and 1 byte into a buffer.
    buf = torch.zeros(c_d.numel() + 1, dtype=torch.uint8, device=dev)
    buf[1:].copy_(c_d.reshape(-1))
    odd = {"narrow": (c_d[:, :-3].contiguous(), c_h[:, :-3].contiguous()),
           "offset": (buf[1:].view(c_d.shape), c_h)}
    for what, (rows_d, rows_h) in odd.items():
        check(rows_d.data_ptr() % 4 != 0 or rows_d.shape[1] % 4 != 0, f"{what}: word rows")
        for base in ("v5", "v6", "v7"):
            got_pre = [x.cpu() for x in dh._prepass(rows_d, base) if x is not None]
            want_pre = dh._prepass(rows_h, base)
            err = max_abs_err(zip(got_pre, want_pre))
            pre_errs[base] = max(pre_errs[base], err)
            check(err == 0, f"prepass_{base} on {what} rows: card != CPU")
            want = [x.numpy() for x in dh.walk_plain(rows_h, *want_pre, l_h, BLOCK, base)]
            for form in [f for f in HYBRID_FORMS if f[:2] == base]:
                got = [x.cpu().numpy() for x in hybrid_call(dh, form)(rows_d, l_d, BLOCK)]
                check(differs(got, want) == 0, f"{form} on {what} rows differs from its plain")
    print(f"decode_v5, decode_v5_spec, decode_v6, decode_v7 (and unroll2) == plain on "
          f"{len(streams)} rows ({n_main} of {BLOCK} B) and on narrow and offset rows; "
          f"pre-passes card == CPU, verdicts == K1's, max_abs_err 0 "
          f"({time.perf_counter() - t0:.1f} s)")

    # 2. the path: the encode kernel's 512 blocks through the production
    # decode kernel and each form, at the codec's row width and the tight one.
    tight = comp_u8[:, : -(-(int(block_lens.max()) + 8) // 1024) * 1024].contiguous()
    widths = (("codec_width", comp_u8), ("tight_width", tight))
    torch.cuda.synchronize()
    _build.reset_launches()
    for width, rows_d in widths:
        k1_out, k1_lens, k1_errs = sc.decode_blocks_bytes(rows_d, block_lens, BLOCK)
        check(bool((k1_errs == 0).all()) and bool((k1_out == frags).all()), "production decode")
        results = {f: hybrid_call(dh, f)(rows_d, block_lens, BLOCK) for f in HYBRID_FORMS}
        results["v5parts"] = dh.decode_v5_spec(dh.pack_words(rows_d), dh.prepass_v5(rows_d),
                                               block_lens, BLOCK)
        for form, (out, out_lens, ferrs) in results.items():
            check(bool((ferrs == 0).all()), f"{form}: errors on the main path ({width})")
            check(bool((out_lens == BLOCK).all()), f"{form}: lengths on the main path ({width})")
            check(bool((out == frags).all()), f"{form}: rows differ from the input ({width})")
            check(bool((out == k1_out).all()), f"{form}: rows differ from decode's ({width})")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"hybrid path launches: {launches}")
    for k in PATHS["hybrid"]:
        check(launches.get(k, 0) > 0, f"kernel {k} did not launch on the hybrid path")
    want_launches = {"decode": 2, "decode_v5": 2, "decode_v5_parts": 2, "decode_v6": 2,
                     "decode_v7": 4, "prepass_v5": 4, "prepass_v6": 2, "prepass_v7": 4}
    check(launches == want_launches, f"launch counts {launches}")
    print(f"hybrid: {B} x {BLOCK} B decoded exactly by K1, decode_v5, decode_v5_spec, decode_v6 "
          "and decode_v7 (with and without unroll2) at both row widths")

    # 3. each form's layout and ptxas figures; timings beside K1 at both
    # widths; the pre-passes alone; each walk alone; the peak device memory
    # of one call of each form.
    layouts = {f: dh.decode_hybrid_layout(comp_u8, BLOCK, f) for f in ("v5", "v6", "v7")}
    log = _build.BUILD_LOG.get("decode_hybrid", "")
    ptxas = {k: ptxas_figures(log, k) for k in ("decode_desc_kernel", "prepass_kernel")}
    print(json.dumps({"card": card, "decode_hybrid_layouts": layouts,
                      "decode_hybrid_ptxas": ptxas}))
    for form, lay in layouts.items():
        check(lay["blocks_per_sm"] >= 3 and lay["loader"] == "words" and lay["threads"] == 64,
              f"{form}: {lay} at out_cap {BLOCK}")
    # Forms 5 and 6 on both loaders, form 7 on both with and without
    # unroll2; the pre-pass of one array and of two, each on words or bytes
    # in, 16-byte or 4-byte stores.
    for k, count in (("decode_desc_kernel", 8), ("prepass_kernel", 8)):
        figs = ptxas[k]
        check(len(figs) == count, f"ptxas figures for the {count} {k}s: {figs}")
        for fig in figs:
            check(all(fig.get(x) == 0 for x in ("stack", "spill_stores", "spill_loads")),
                  f"{k} stack frame or spills: {fig}")
    ntags, _ = tag_mix(comp_u8[0, : int(block_lens[0])].cpu().numpy().tobytes())
    times = {}
    for width, rows_d in widths:
        cc = rows_d.shape[1]
        in_flight = {f: 132 * dh.decode_hybrid_layout(rows_d, BLOCK, f)["blocks_per_sm"]
                     for f in ("v5", "v6", "v7")}
        waves = {f: -(-B // n) for f, n in in_flight.items()}
        t = {"row_bytes": cc, **{f"{f}_blocks_in_flight": n for f, n in in_flight.items()},
             "k1": cuda_ms(lambda: sc.decode_blocks_bytes(rows_d, block_lens, BLOCK)),
             "prepass_v5": cuda_ms(lambda: dh.prepass_v5(rows_d)),
             "prepass_v5_tensor": cuda_ms(lambda: (dh.spec_from_comp(rows_d),
                                                   dh.pack_words(rows_d))),
             "prepass_v6": cuda_ms(lambda: dh.prepass_v6(rows_d)),
             "prepass_v6_tensor": cuda_ms(lambda: dh.spec_from_words(dh.pack_words(rows_d), cc)),
             "prepass_v7": cuda_ms(lambda: dh.prepass_v7(rows_d)),
             "prepass_v7_tensor": cuda_ms(lambda: dh.spec2_from_words(dh.pack_words(rows_d), cc))}
        words, spec = dh.pack_words(rows_d), dh.prepass_v5(rows_d)
        t["v5parts_kernel"] = cuda_ms(lambda: dh.decode_v5_spec(words, spec, block_lens, BLOCK))
        t["v5parts_kernel_ns_per_tag"] = t["v5parts_kernel"] * 1e6 / waves["v5"] / ntags
        t["v5parts_with_prepass"] = cuda_ms(lambda: dh.decode_v5_spec(
            dh.pack_words(rows_d), dh.prepass_v5(rows_d), block_lens, BLOCK))
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dh.decode_v5_spec(dh.pack_words(rows_d), dh.prepass_v5(rows_d), block_lens, BLOCK)
        torch.cuda.synchronize()
        t["v5parts_peak_bytes"] = torch.cuda.max_memory_allocated() - base_mem
        # The walks alone, each on its own pre-pass made beforehand.
        for form in HYBRID_FORMS:
            pre = dh._prepass(rows_d, form[:2])
            t[form + "_walk"] = cuda_ms(lambda: dh._launch(
                form[:2], form == "v7u", rows_d, pre[0], pre[1], block_lens, BLOCK,
                dh.FORMS[form[:2]][1]))
            t[form + "_walk_ns_per_tag"] = t[form + "_walk"] * 1e6 / waves[form[:2]] / ntags
            del pre
        k1_in_flight = 132 * max(1, 233472 // (((BLOCK + 15) & ~15) + 1024))  # csrc/decode.cu
        t["k1_ns_per_tag"] = t["k1"] * 1e6 / -(-B // k1_in_flight) / ntags
        del words, spec
        base_mem = torch.cuda.memory_allocated()
        for form in HYBRID_FORMS:
            fn = hybrid_call(dh, form)
            t[form] = cuda_ms(lambda: fn(rows_d, block_lens, BLOCK))
            t[form + "_ns_per_tag"] = t[form] * 1e6 / waves[form[:2]] / ntags
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn(rows_d, block_lens, BLOCK)
            torch.cuda.synchronize()
            t[form + "_peak_bytes"] = torch.cuda.max_memory_allocated() - base_mem
        times[width] = t
    print(json.dumps({"card": card, "tags_per_block": ntags, "hybrid_ms_per_512_blocks": times}))
    cw = times["codec_width"]
    ms = {"decode_v5": cw["v5"], "decode_v5_parts": cw["v5parts_kernel"],
          "decode_v6": cw["v6"], "decode_v7": cw["v7"]}
    c1, cl1 = comp_u8[:1].cpu(), block_lens[:1].cpu()
    w1, s1 = dh.pack_words(c1), dh.spec_from_comp(c1)
    plain = {dh.FORMS[f][1]: host_ms(lambda: dh.decode_hybrid_plain(c1, cl1, BLOCK, f))
             for f in ("v5", "v6", "v7")}
    plain["decode_v5_parts"] = host_ms(lambda: dh.decode_v5_spec(w1, s1, cl1, BLOCK))
    tpu_prepass = {"v5": "tools/perf_probe_hybrid.py:533", "v6": "tools/perf_probe_hybrid.py:905",
                   "v7": "tools/perf_probe_hybrid.py:1271"}

    def prepass_row(form):
        """A pre-pass kernel's entry, riding in its form's row: it reads a
        byte and writes 4 (8 for v7) a position."""
        return {"route": "cuda", "source": "snappier_tpu_torch/csrc/decode_hybrid.cu",
                "replaces": tpu_prepass[form], "launches": launches.get(f"prepass_{form}", 0),
                "max_abs_err": pre_errs[form], "ms": cw[f"prepass_{form}"],
                "tensor_ms": cw[f"prepass_{form}_tensor"],
                "plain_ms": host_ms(lambda: dh._prepass(c1, form)),
                "bound_ms": (9 if form == "v7" else 5) * B * comp_u8.shape[1]
                / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}

    ptx = {"decode_desc_kernel": ptxas["decode_desc_kernel"]}
    extra = {
        "decode_v5": {"layout": {**layouts["v5"], "ptxas": ptx}, "walk_ms": cw["v5_walk"],
                      "prepass_v5": prepass_row("v5")},
        "decode_v5_parts": {"layout": {**layouts["v5"], "ptxas": ptx},
                            "with_prepass_ms": cw["v5parts_with_prepass"]},
        "decode_v6": {"layout": {**layouts["v6"], "ptxas": ptx}, "walk_ms": cw["v6_walk"],
                      "prepass_v6": prepass_row("v6")},
        "decode_v7": {"layout": {**layouts["v7"], "ptxas": ptx}, "walk_ms": cw["v7_walk"],
                      "unroll2_ms": cw["v7u"], "unroll2_walk_ms": cw["v7u_walk"],
                      "prepass_v7": prepass_row("v7")},
    }
    for row in extra.values():
        row["layout"]["prepass_ptxas"] = ptxas["prepass_kernel"]
    return errs, launches, ms, plain, extra


def phase_micro_probes(torch, card, frags, lengths, comp_u8, block_lens):
    """Phase 10, the micro_probes path. Returns (max_abs_err per wrapper,
    launches on the path, ms per wrapper, plain ms per wrapper on one input,
    (bytes, operations) per wrapper at the timed call, row extras by
    wrapper: T9's layout and ptxas figures; chain's forms' ms, ns a step and
    ptxas figures; coissue's ms and ns an iteration at every nvec, its two
    floors (nvec 0, the chain alone, and the vector stream alone) and ptxas
    figures)."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    from torch_cases import encode_rows as small_rows

    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import encode_variants as ev
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    dev = torch.device("cuda")
    errs = {}
    t0 = time.perf_counter()
    # 1. each kernel against its plain version. T9: markup, random, zero,
    # period-1..7 and short rows of 4 KiB with garbage past each length, an
    # empty row, and 9 of the main path's fragments of 65,536 B.
    f_small, l_small = small_rows(4096)
    picks = torch.from_numpy(np.linspace(0, B - 1, 9).astype(np.int64)).to(dev)
    f_main, l_main = frags[picks].cpu(), lengths[picks].cpu()
    cases = [(torch.from_numpy(np.concatenate([f_small, f_small[:1]]).astype(np.uint8)),
              torch.from_numpy(np.concatenate([l_small, [0]]).astype(np.int32))),
             (f_main, l_main)]
    errs["encode_stats"] = 0
    for f_h, l_h in cases:
        got = ev.encode_stats(f_h.to(dev), l_h.to(dev)).cpu().numpy()
        want = ev.encode_stats_plain(f_h, l_h).numpy()
        err = max_abs_err([(got, want)])
        check(err == 0, f"encode_stats differs from its plain walk on rows of {f_h.shape[1]} B")
        errs["encode_stats"] = max(errs["encode_stats"], err)
    stats_picks = want
    # T9 runs in K2's layout: one warp a fragment, the 15-bit table alone in
    # shared memory, three blocks an SM, so the 512 fragments take two waves.
    stats_layout = ev.encode_stats_layout(frags)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    waves = -(-B // (n_sm * max(stats_layout["blocks_per_sm"], 1)))
    check(stats_layout == {"blocks_per_sm": 3, "smem_bytes": 65536, "threads": 32,
                           "loader": "words"}, f"encode_stats layout {stats_layout}")
    stats_ptxas = ptxas_figures(_build.BUILD_LOG.get("encode_stats", ""), "_kernel")
    print(f"encode_stats layout: {stats_layout}, {waves} waves of {B} fragments on {n_sm} SMs; "
          f"ptxas {stats_ptxas}")
    check(len(stats_ptxas) == 2 and all(
        f["stack"] == f["spill_stores"] == f["spill_loads"] == 0 for f in stats_ptxas),
        f"encode_stats kernels: {stats_ptxas}")
    # T10-T12 on the encode kernel's block 0: its advance array, its records.
    block = comp_u8[0, : int(block_lens[0])].cpu().numpy().tobytes()
    adv, n, ntags = hp.chain_inputs(block)
    rec = hp.vcopy_records(hp.tags_from_block(block)[1])
    count = int(rec[hp.COUNT_AT])
    img = np.arange(hp.IMAGE_WORDS, dtype=np.int32)
    adv_h, rec_h, img_h = (torch.from_numpy(x) for x in (adv, rec, img))
    adv_d, rec_d, img_d = (x.to(dev) for x in (adv_h, rec_h, img_h))
    fill = torch.full(hp.TILE, hp.FILL, dtype=torch.int32)
    rand = torch.from_numpy(np.random.default_rng(29).integers(
        -(1 << 31), 1 << 31, hp.TILE, dtype=np.int64).astype(np.int32))
    fill_d = fill.to(dev)

    def compare(name, got, want, what):
        err = max_abs_err([(a.cpu().numpy(), b.numpy()) for a, b in zip(got, want)])
        check(err == 0, f"{name} differs from its plain version ({what})")
        errs[name] = max(errs.get(name, 0), err)

    plain_chk = {}
    for wr in (False, True):
        want = hp.chain_plain(adv_h, n, 3, hp.CHAIN_R, wr)
        compare("chain", hp.chain(adv_d, n, 3, hp.CHAIN_R, wr), want, f"with_rec={wr}")
        plain_chk[wr] = int(want[0])
    for mode in hp.MODES:
        compare("vcopy", hp.vcopy(rec_d, img_d, mode), hp.vcopy_plain(rec_h, img_h, mode), mode)
    co_cases = ((fill, 8192), (rand, 8192), (rand, 5), (rand, 37))
    for nvec in hp.COISSUE_NVEC:
        for tile, iters in co_cases:
            compare("coissue", hp.coissue(3, nvec, tile.to(dev), iters),
                    hp.coissue_plain(3, nvec, tile, iters), f"nvec {nvec}, {iters} iterations")
    for tile, iters in co_cases:
        compare("coissue_vec", hp.coissue_vec(tile.to(dev), iters),
                hp.coissue_vec_plain(tile, iters), f"the vector stream alone, {iters} iterations")
    steps = plain_chk[True] - plain_chk[False]  # chainrec adds each trial's steps
    check(steps > 0, "chainrec's checksum must exceed chain's")
    print(f"encode_stats == plain on {len(cases[0][1])} rows of 4096 B and 9 of {BLOCK} B; "
          f"chain, chainrec ({hp.CHAIN_R} walks, {steps} steps), vcopy 2d and 3d "
          f"({count} records), coissue (nvec {hp.COISSUE_NVEC}) and its vector stream alone "
          f"== plain on block 0 ({ntags} tags), max_abs_err 0 "
          f"({time.perf_counter() - t0:.1f} s)")

    # 2. the path: the encoder's budget of the 512 fragments; the probes at
    # the tool's sizes.
    torch.cuda.synchronize()
    _build.reset_launches()
    stats = ev.encode_stats(frags, lengths)
    chk = {wr: hp.chain(adv_d, n, 3, hp.CHAIN_R, wr) for wr in (False, True)}
    vc = {mode: hp.vcopy(rec_d, img_d, mode) for mode in hp.MODES}
    co = {nvec: hp.coissue(3, nvec, fill_d) for nvec in (0, 8)}
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"micro_probes path launches: {launches}")
    for k in PATHS["micro_probes"]:
        check(launches.get(k, 0) > 0, f"kernel {k} did not launch on the micro_probes path")
    check(launches == {"encode_stats": 1, "chain": 2, "vcopy": 2, "coissue": 2},
          f"launch counts {launches}")
    st = stats.cpu().numpy()
    check(st.shape == (B, 4) and (st >= 0).all() and (st[:, 3] <= BLOCK).all(),
          "encode_stats: counts out of range")
    check(bool((st[picks.cpu().numpy()] == stats_picks).all()),
          "encode_stats: the 9 fragments differ from the plain walk on the path")
    check([int(chk[wr][0]) for wr in (False, True)] == [plain_chk[False], plain_chk[True]],
          "chain checksums on the path")
    check(int(vc["2d"][0]) != int(vc["3d"][0]), "vcopy 2d and 3d agree where the TPU's differ")
    check(int(co[0][0]) == int(co[8][0]), "coissue's sum must not see the tile at 8,192")
    avg = st.sum(axis=0) / B
    print(f"encstats (per block avg): miss_iters={avg[0]:.0f} hits={avg[1]:.0f} "
          f"ext_iters={avg[2]:.0f} match_bytes={avg[3]:.0f} "
          f"(ext iters/hit={avg[2] / max(avg[1], 1):.2f}, "
          f"match len avg={avg[3] / max(avg[1], 1):.1f})")

    # 3. timings: each kernel alone (the wrappers' checks sync with the
    # host), encode_stats beside the encode kernel.
    t = {"k2": cuda_ms(lambda: sc.encode_blocks_bytes(frags, lengths), iters=3),
         "encode_stats": cuda_ms(lambda: ev.encode_stats(frags, lengths), iters=3)}
    staged = hp.cliff_staged_words(adv_h, n, 3)
    for wr, name in ((False, "chain"), (True, "chainrec")):
        t[name] = cuda_ms(lambda: hp.launch_chain(adv_d, n, 3, hp.CHAIN_R, wr, staged))
        t[name + "_ns_per_step"] = t[name] * 1e6 / steps
        t[name + "_ns_per_tag"] = t[name] * 1e6 / hp.CHAIN_R / ntags
    for mode in hp.MODES:
        t["vcopy" + mode] = cuda_ms(lambda: hp.launch_vcopy(rec_d, img_d, mode))
        t["vcopy" + mode + "_ns_per_record"] = t["vcopy" + mode] * 1e6 / count
    # coissue at every nvec and, off the path, its vector stream alone.
    co_forms = [f"coissue{nvec}" for nvec in hp.COISSUE_NVEC] + ["coissue_vec"]
    for nvec in hp.COISSUE_NVEC:
        t[f"coissue{nvec}"] = cuda_ms(lambda: hp.launch_coissue(3, nvec, fill_d))
    t["coissue_vec"] = cuda_ms(lambda: hp.launch_coissue_vec(fill_d))
    for k in co_forms:
        t[k + "_ns_per_iter"] = t[k] * 1e6 / hp.COISSUE_ITERS
    # chain and chainrec run cliff's walk (cliff_kernel<kChase>, <kChainRec>).
    log = _build.BUILD_LOG.get("hybrid_probes", "")
    chain_ptxas = {name: ptxas_figures(log, f"cliff_kernelILi{mode}E")
                   for name, mode in (("chain", 5), ("chainrec", 6))}
    co_ptxas = ptxas_figures(log, "coissue_kernel")
    print(json.dumps({"card": card, "tags_block0": ntags, "chain_walks": hp.CHAIN_R,
                      "chain_steps": steps, "vcopy_records": count,
                      "encode_stats_per_block_avg": avg.tolist(), "micro_probe_ms": t,
                      "chain_ptxas": chain_ptxas, "coissue_ptxas": co_ptxas}))
    check(all(len(f) == 1 and f[0]["stack"] == f[0]["spill_stores"] == f[0]["spill_loads"] == 0
              for f in chain_ptxas.values()), f"chain kernels: {chain_ptxas}")
    check(len(co_ptxas) == len(co_forms) and all(
        f["stack"] == f["spill_stores"] == f["spill_loads"] == 0 for f in co_ptxas),
        f"coissue kernels: {co_ptxas}")
    ms = {"encode_stats": t["encode_stats"], "chain": t["chain"], "vcopy": t["vcopy2d"],
          "coissue": t["coissue8"]}
    f1, l1 = frags[:1].cpu(), lengths[:1].cpu()
    plain = {"encode_stats": host_ms(lambda: ev.encode_stats_plain(f1, l1)),
             "chain": host_ms(lambda: hp.chain_plain(adv_h, n, 3, hp.CHAIN_R)),
             "vcopy": host_ms(lambda: hp.vcopy_plain(rec_h, img_h, "2d")),
             "coissue": host_ms(lambda: hp.coissue_plain(3, 8))}
    # Bytes each timed call must move (inputs read once, outputs written
    # once) and its operations: a step per byte (T9), per walk step (T10),
    # per record lane (T11), per scalar operation and tile update (T12).
    work = {"encode_stats": (B * BLOCK + 4 * B + 16 * B, B * BLOCK),
            "chain": (4 * len(adv) + 4, steps),
            "vcopy": (4 * (hp.VCOPY_WORDS + 2 * hp.IMAGE_WORDS) + 4, count * hp.LANES),
            "coissue": (2 * 4 * hp.TILE[0] * hp.TILE[1] + 4,
                        hp.COISSUE_ITERS * (24 + 8 * hp.TILE[0] * hp.TILE[1]))}
    extra = {
        "encode_stats": {"layout": {**stats_layout, "waves": waves, "ptxas": stats_ptxas},
                         "ms_beside": {"k2": t["k2"]}},
        "chain": {"ms_by_form": {k: t[k] for k in ("chain", "chainrec")},
                  "ns_per_step": {k: t[k + "_ns_per_step"] for k in ("chain", "chainrec")},
                  "steps": steps, "staged_words": staged,
                  "ptxas": {k: f[0] for k, f in chain_ptxas.items()}},
        "coissue": {"ms_by_nvec": {k: t[k] for k in co_forms},
                    "ns_per_iter": {k: t[k + "_ns_per_iter"] for k in co_forms},
                    "floors": {"chain_alone": {"nvec": 0, "ms": t["coissue0"]},
                               "vector_alone": {"ms": t["coissue_vec"],
                                                "max_abs_err": errs["coissue_vec"]}},
                    "ptxas": co_ptxas}}
    return errs, launches, ms, plain, work, extra


ISOLATION_NWHEN = (0, 1, 3, 8)  # compared and on the path; every built nwhen is timed


def phase_isolation(torch, card, comp_u8, block_lens):
    """Phase 11, the isolation path. Returns (max_abs_err per wrapper,
    launches on the path, ms per wrapper, plain ms per wrapper, (bytes,
    operations) per wrapper at the timed call, torch.sort's ms, cliff's row
    extras: the chase and every mode's ns a step, bprobe's row extras: every
    nwhen's ms and ns an iteration, the floor, ptxas figures)."""
    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    block = comp_u8[0, : int(block_lens[0])].cpu().numpy().tobytes()
    adv, n, ntags = hp.chain_inputs(block)
    irec = hp.iso_records(hp.tags_from_block(block)[1])
    count = int(irec[hp.COUNT_AT])
    rng = np.random.default_rng(5)  # the JAX tool's keys
    keys = rng.integers(-(2**31), 2**31 - 1, hp.SORT_SHAPE, np.int64).astype(np.int32)
    ties = np.random.default_rng(9).integers(-4, 4, hp.SORT_SHAPE).astype(np.int32)
    h = {k: torch.from_numpy(v) for k, v in dict(
        adv=adv, irec=irec, img=np.arange(hp.IMAGE_WORDS, dtype=np.int32), keys=keys,
        ties=ties).items()}
    d = {k: v.to(dev) for k, v in h.items()}
    R = hp.CHAIN_R
    staged = hp.cliff_staged_words(h["adv"], n, 3)
    calls = {  # name -> (wrapper, kernel alone, plain version)
        **{("iso", m): (lambda m=m: hp.iso(d["irec"], d["img"], m),
                        lambda m=m: hp.launch_iso(d["irec"], d["img"], m),
                        lambda m=m: hp.iso_plain(h["irec"], h["img"], m)) for m in hp.ISO_MODES},
        **{("bprobe", w): (lambda w=w: hp.bprobe(w, 3, dev),
                           lambda w=w: hp.launch_bprobe(w, 3, dev),
                           lambda w=w: hp.bprobe_plain(w, 3)) for w in hp.BPROBE_NWHEN},
        **{("cliff", m): (lambda m=m: hp.cliff(d["adv"], n, m, 3, R),
                          lambda m=m: hp.launch_cliff(d["adv"], n, m, 3, R, staged),
                          lambda m=m: hp.cliff_plain(h["adv"], n, m, 3, R))
           for m in hp.CLIFF_MODES},
        **{("bitonic", k): (lambda k=k: hp.bitonic(d[k]), lambda k=k: hp.launch_bitonic(d[k]),
                            lambda k=k: hp.bitonic_plain(h[k])) for k in ("keys", "ties")},
        # The chase: cliff's walk with no body, chain's function.
        ("chase", "floor"): (lambda: (hp.chase(d["adv"], n, 3, R),),
                             lambda: hp.launch_chase(d["adv"], n, 3, R, staged),
                             lambda: (hp.chain_plain(h["adv"], n, 3, R)[0],)),
        # bprobe's floor: its mix alone, no scratch.
        ("bprobe_floor", "floor"): (lambda: (hp.bprobe_floor(3, dev),),
                                    lambda: hp.launch_bprobe_floor(3, dev),
                                    lambda: (hp.bprobe_floor_plain(3),)),
    }
    compared = [c for c in calls if c[0] != "bprobe" or c[1] in ISOLATION_NWHEN]

    # 1. each wrapper against its plain version on block 0, exact, the
    # image, scratch and indices included; the plain call timed by the host.
    errs, plain, results = {}, {}, {}
    for c in compared:
        got = [x.cpu().numpy() for x in calls[c][0]()]
        ts = time.perf_counter()
        want = [x.numpy() for x in calls[c][2]()]
        plain_ms = (time.perf_counter() - ts) * 1e3
        err = max_abs_err(zip(got, want))
        check(err == 0, f"{c[0]} differs from its plain version ({c[1]})")
        errs[c[0]] = max(errs.get(c[0], 0), err)
        plain[c] = plain_ms
        results[c] = want
    print(f"iso ({', '.join(hp.ISO_MODES)}; {hp.ISO_PASSES} x {count} records), bprobe (nwhen "
          f"{ISOLATION_NWHEN}) and its floor, cliff ({', '.join(hp.CLIFF_MODES)}; {R} walks), the "
          f"chase and bitonic (the tool's keys, keys with ties) == plain on block 0 ({ntags} tags), "
          f"max_abs_err 0 ({time.perf_counter() - t0:.1f} s)")
    # What the checksums do not see, seen here: four iso modes give one sum
    # and four images; bprobe 0 and 3 are one function; cliff's img[0].
    iso_sums = {m: int(results[("iso", m)][0][0]) for m in hp.ISO_MODES}
    check(len({iso_sums[m] for m in ("dynload", "dynload8", "statroll", "dynroll")}) == 1,
          f"iso's row modes should share one checksum: {iso_sums}")
    check(len({results[("iso", m)][1].tobytes() for m in hp.ISO_MODES}) == len(hp.ISO_MODES),
          "iso's six images should differ")
    b0, b3 = results[("bprobe", 0)], results[("bprobe", 3)]
    check(int(b0[0][0]) == int(b3[0][0]) and (b0[1] == b3[1]).all(), "bprobe 0 and 3 differ")
    # The copy probes' record loops (iso and vcopy, one source): no stack,
    # no spill; their shared bytes are the image and the plan ring.
    copy_ptxas = [f for k in ("iso_kernel", "vcopy_kernel")
                  for f in ptxas_figures(_build.BUILD_LOG.get("hybrid_probes", ""), k)]
    print(json.dumps({"copy_probe_ptxas": copy_ptxas,
                      "copy_probe_smem_bytes": hp.COPY_SMEM_BYTES}))
    check(len(copy_ptxas) == len(hp.ISO_MODES) + len(hp.MODES)
          and all(f["stack"] == f["spill_stores"] == f["spill_loads"] == 0 for f in copy_ptxas),
          f"iso and vcopy kernels: {copy_ptxas}")
    # bprobe's scratch lives in registers: no stack, no spill in any nwhen's
    # kernel or the floor's.
    log = _build.BUILD_LOG.get("hybrid_probes", "")
    bprobe_ptxas = {w: ptxas_figures(log, f"bprobe_kernelILi{w}E") for w in hp.BPROBE_NWHEN}
    bprobe_ptxas["floor"] = ptxas_figures(log, "bprobe_floor_kernel")
    print(json.dumps({"bprobe_ptxas": bprobe_ptxas}))
    check(all(len(f) == 1 and f[0]["stack"] == f[0]["spill_stores"] == f[0]["spill_loads"] == 0
              for f in bprobe_ptxas.values()), f"bprobe kernels: {bprobe_ptxas}")
    bprobe_ptxas = {w: f[0] for w, f in bprobe_ptxas.items()}
    for k, x in (("keys", keys), ("ties", ties)):
        kv, vv = (a.reshape(-1) for a in results[("bitonic", k)])
        check((kv == x.reshape(-1)[vv]).all() and len(np.unique(vv)) == hp.SORT_N,
              f"bitonic's indices on the {k} are not where its keys came from")

    # 2. the path: the same calls once each, on the card.
    torch.cuda.synchronize()
    _build.reset_launches()
    path = {c: calls[c][0]() for c in compared}
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"isolation path launches: {launches}")
    for k in PATHS["isolation"]:
        check(launches.get(k, 0) > 0, f"kernel {k} did not launch on the isolation path")
    check(launches == {"iso": len(hp.ISO_MODES), "bprobe": len(ISOLATION_NWHEN),
                       "cliff": len(hp.CLIFF_MODES), "bitonic": 2, "chase": 1,
                       "bprobe_floor": 1}, f"launch counts {launches}")
    for c, out in path.items():
        check(all((a.cpu().numpy() == b).all() for a, b in zip(out, results[c])),
              f"{c} on the path differs from its plain version")
    cliff_img0 = {m: int(results[("cliff", m)][1][0]) for m in hp.CLIFF_MODES}

    # 3. timings: each kernel alone; torch.sort of the same keys (a full
    # stable sort with its indices: not the same function) beside bitonic.
    t = {f"{c[0]}:{c[1]}": cuda_ms(calls[c][1]) for c in calls}
    flat = d["keys"].reshape(-1)
    sort_ms = cuda_ms(lambda: torch.sort(flat, stable=True))
    # bitonic's device time (graph-replayed, no host time) beside torch.sort's.
    sort_extra = {"ms_graph": graph_ms(lambda: hp.launch_bitonic(d["keys"])),
                  "library_ms_graph": graph_ms(lambda: torch.sort(flat, stable=True))}
    # Walk steps of cliff's 200 trials (odd trials start one byte in).
    adv_l = adv.tolist()
    walk = {s: hp._chain_trial(adv_l, n, s, None)[1] for s in (3, 4)}
    steps = sum(walk[3 + (r & 1)] for r in range(R))
    per = {"iso_ns_per_record": {m: t[f"iso:{m}"] * 1e6 / (hp.ISO_PASSES * count - 10)
                                 for m in hp.ISO_MODES},
           "bprobe_ns_per_iter": {w: t[f"bprobe:{w}"] * 1e6 / hp.BPROBE_ITERS
                                  for w in hp.BPROBE_NWHEN},
           "bprobe_floor_ns_per_iter": t["bprobe_floor:floor"] * 1e6 / hp.BPROBE_ITERS,
           "cliff_ns_per_tag": {m: t[f"cliff:{m}"] * 1e6 / R / ntags for m in hp.CLIFF_MODES},
           "cliff_ns_per_step": {m: t[f"cliff:{m}"] * 1e6 / steps for m in hp.CLIFF_MODES},
           "chase_ns_per_step": t["chase:floor"] * 1e6 / steps}
    per["cliff_over_chase"] = {m: per["cliff_ns_per_step"][m] / per["chase_ns_per_step"]
                               for m in hp.CLIFF_MODES}
    per["bprobe_over_floor"] = {w: t[f"bprobe:{w}"] / t["bprobe_floor:floor"]
                                for w in hp.BPROBE_NWHEN}
    print(json.dumps({"card": card, "tags_block0": ntags, "iso_records": count,
                      "cliff_steps": steps, "iso_checksums": iso_sums,
                      "cliff_img0": cliff_img0, "isolation_ms": t, "torch_sort_ms": sort_ms,
                      **per}))
    ms = {"iso": t["iso:full"], "bprobe": t["bprobe:8"], "cliff": t["cliff:store4"],
          "bitonic": t["bitonic:keys"]}
    plain_ms = {"iso": plain[("iso", "full")], "bprobe": plain[("bprobe", 8)],
                "cliff": plain[("cliff", "store4")], "bitonic": plain[("bitonic", "keys")]}
    # Bytes each timed call must move (inputs read once, outputs written
    # once) and its 32-bit operations: a lane of a record (iso full), the
    # chain's 13 operations and a test and a store per conditional store
    # (bprobe 8), a walk step and its 4 stores (cliff store4), a
    # compare-exchange per element per stage (bitonic).
    work = {"iso": (4 * (hp.VCOPY_WORDS + 2 * hp.IMAGE_WORDS) + 4,
                    (hp.ISO_PASSES * count - 10) * hp.LANES),
            "bprobe": (4 + 4 * hp.SCRATCH_WORDS, hp.BPROBE_ITERS * (13 + 2 * 8)),
            "cliff": (4 * len(adv) + 4 + 4 * hp.IMAGE_WORDS, steps * 5),
            "bitonic": (4 * hp.SORT_N + 8 * hp.SORT_N, (hp.BITONIC_K + 1) * hp.SORT_N)}
    cliff_extra = {"ns_per_step": per["cliff_ns_per_step"], "staged_words": staged,
                   "ms_by_mode": {m: t[f"cliff:{m}"] for m in hp.CLIFF_MODES},
                   "chase": {"launches": launches["chase"], "max_abs_err": errs["chase"],
                             "ms": t["chase:floor"], "ns_per_step": per["chase_ns_per_step"],
                             "steps": steps}}
    bprobe_extra = {"ms_by_nwhen": {w: t[f"bprobe:{w}"] for w in hp.BPROBE_NWHEN},
                    "ns_per_iter": per["bprobe_ns_per_iter"],
                    "over_floor": per["bprobe_over_floor"], "ptxas": bprobe_ptxas,
                    "floor": {"launches": launches["bprobe_floor"],
                              "max_abs_err": errs["bprobe_floor"], "ms": t["bprobe_floor:floor"],
                              "ns_per_iter": per["bprobe_floor_ns_per_iter"]}}
    return errs, launches, ms, plain_ms, work, sort_ms, cliff_extra, bprobe_extra, sort_extra


def phase_fuzz(torch, card):
    """Phase 12, the fuzz path: every campaign of ``tools/torch_fuzz.py`` at
    its reduced volumes, then the B=2,048 codec check. A mismatch writes its
    input under ``build/fuzz/`` and fails. Returns the path's launches."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import torch_fuzz

    from snappier_tpu_torch.ops.cuda import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        results = torch_fuzz.run_campaigns(torch_fuzz.CAMPAIGNS, torch_fuzz.QUICK, 301, "cuda")
        results.append(torch_fuzz.bigbatch(2048, 301, "cuda"))
    except torch_fuzz.Mismatch as m:
        check(False, f"fuzz mismatch: {m} (input in {torch_fuzz.write_failure(m)})")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(torch_fuzz.summary_line(results[-1]))
    print(f"fuzz path launches: {launches}, {seconds:.1f} s")
    for k in PATHS["fuzz"]:
        check(launches.get(k, 0) > 0, f"kernel {k} did not launch on the fuzz path")
    corrupt = next(r for r in results if r["campaign"] == "corrupt")
    check(corrupt["loaders"].get("ring") == corrupt["loaders"].get("bytes") == corrupt["batches"],
          f"corrupt batches did not take both loaders: {corrupt['loaders']}")
    keys = ("campaign", "rows", "bytes", "seconds", "launches", "mutants", "oracle_judged",
            "verdicts", "loaders", "crc_caught", "ratio")
    print(json.dumps({"card": card, "fuzz_seconds": seconds, "fuzz": [
        {k: r[k] for k in keys if k in r} for r in results]}))
    return launches


def trace_kernel_us(log_dir) -> dict:
    """Device time (us) by kernel name in the Chrome trace(s) under
    ``log_dir``: the events of category ``kernel``."""
    import pathlib

    us: dict = {}
    for f in sorted(pathlib.Path(log_dir).glob("*.json")):
        for e in json.loads(f.read_text()).get("traceEvents", []):
            if e.get("cat") == "kernel":
                us[e["name"]] = us.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    return us


def phase_tools(torch, card, codec, frags, lengths, ms):
    """Phase 13, the tools path: the multi-process rehearsal at its default
    size in a subprocess, the ratio table on the card against its CPU
    columns, and a trace of one codec round trip of the phase-3 batch.
    Returns the path's launches, the rehearsal workers' summed in."""
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import torch_ratio_table as rt

    from snappier_tpu_torch.format import oracle
    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.utils.profiling import Throughput, device_trace

    root = os.path.dirname(os.path.abspath(__file__))
    secs = {}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # room for the workers' four contexts
    _build.reset_launches()

    # (a) 4,096 x 64 KiB over 4 processes x 2 shards of the card, on gloo.
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(root, "tools", "torch_rehearsal_multihost.py")],
                       capture_output=True, text=True, timeout=600, cwd=root)
    secs["rehearsal"] = time.perf_counter() - t0
    check(r.returncode == 0, f"rehearsal failed ({r.returncode}):\n{r.stdout[-2000:]}"
          f"{r.stderr[-4000:]}")
    reh = json.loads(r.stdout.strip().splitlines()[-1])
    print(json.dumps({"card": card, "rehearsal": reh}))
    check(reh["bit_exact"] is True and reh["decoded_exact"] is True, f"rehearsal: {reh}")
    check((reh["blocks"], reh["nprocs"], reh["devices_per_proc"]) == (4096, 4, 2)
          and reh["device"].startswith("cuda") and reh["backend"] == "gloo", f"rehearsal: {reh}")
    check(reh["launches"].get("encode", 0) > 0 and reh["launches"].get("decode", 0) > 0,
          f"the rehearsal's workers launched no kernel: {reh['launches']}")

    # (b) The ratio table: the card's streams against the CPU's (the plain
    # versions, which the tests hold to the JAX package), each decoded by
    # the oracle, and best no larger than greedy.
    files = rt.corpus()
    t0 = time.perf_counter()
    host = rt.device_streams(files, "cpu")
    secs["ratio_cpu_columns"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = rt.device_streams(files, "cuda")
    torch.cuda.synchronize()
    secs["ratio_card_columns"] = time.perf_counter() - t0
    for name, data in files.items():
        for col in rt.DEVICE_COLUMNS:
            check(dev[name][col] == host[name][col], f"ratio table: {name} {col} differs from "
                  f"the CPU's ({len(dev[name][col])} against {len(host[name][col])} B)")
            check(oracle.decompress(dev[name][col]) == data, f"ratio table: {name} {col} "
                  "does not decode to its stand-in")
        check(len(dev[name]["best"]) <= len(dev[name]["scalar"]),
              f"ratio table: best is larger than greedy on {name}")
    rows = rt.table(files, "cuda", streams=dev)
    print(json.dumps({"card": card, "ratio_table": rows}))
    print(rt.markdown(rows))

    # (c) A trace of one round trip of the phase-3 batch: its device events
    # must name the encode and decode kernels, launched through ctypes.
    def roundtrip():
        bodies, body_lens, _ = codec.compress_batch(frags, lengths)
        n = frags.shape[0]
        pre = torch.tensor([0x80, 0x80, 0x04], dtype=torch.uint8, device=frags.device)
        blocks = torch.cat([pre.expand(n, 3), bodies.to(torch.uint8)], dim=1)
        blocks = torch.nn.functional.pad(blocks, (0, (-blocks.shape[1]) % 1024))
        return codec.decompress_batch(blocks, body_lens + 3, out_cap=BLOCK)

    nbytes = 2 * frags.shape[0] * frags.shape[1]  # bench.py's combined count
    roundtrip()
    with Throughput(nbytes) as t_plain:
        outs, _, errs = roundtrip()
    check(bool((errs == 0).all()) and bool((outs == frags.to(torch.int32)).all()),
          "the traced round trip differs")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with device_trace(d) as prof, Throughput(nbytes) as t_traced:
            roundtrip()
        secs["trace"] = time.perf_counter() - t0
        kernels_us = trace_kernel_us(d)
        trace_files = len(list(os.scandir(d)))
    named = {k: sum(us for n, us in kernels_us.items() if k in n)
             for k in ("encode_kernel", "decode_kernel", "crc32c_kernel")}
    print(json.dumps({
        "card": card, "trace_files": trace_files, "trace_kernel_us": kernels_us,
        "k2_encode_kernel_trace_ms": named["encode_kernel"] / 1e3,
        "k1_decode_kernel_trace_ms": named["decode_kernel"] / 1e3,
        "k3_crc32c_kernel_trace_ms": named["crc32c_kernel"] / 1e3,
        "phase4_encode_ms": ms["encode"], "phase4_decode_ms": ms["decode"],
        "phase4_crc32c_ms": ms["crc32c"],
        "roundtrip_combined_gbps": t_plain.gbps, "roundtrip_s": t_plain.seconds,
        "roundtrip_combined_gbps_traced": t_traced.gbps,
        "profiler_rows": len(prof.key_averages()),
    }))
    check(named["encode_kernel"] > 0 and named["decode_kernel"] > 0,
          f"the trace names no encode_kernel or decode_kernel: {sorted(kernels_us)}")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for k, v in reh["launches"].items():
        launches[k] = launches.get(k, 0) + v
    print(f"tools path launches: {launches} (the rehearsal's workers: {reh['launches']}); "
          f"seconds {json.dumps(secs)}; the phase {time.perf_counter() - t_phase:.1f} s")
    for k in PATHS["tools"]:
        check(launches.get(k, 0) > 0, f"kernel {k} did not launch on the tools path")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2

    if importlib.util.find_spec("snappier_tpu_torch") is None:
        print("chip_smoke: snappier_tpu_torch not found; run this script from the repo's root",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    import snappier_tpu_torch as st
    from snappier_tpu_torch import SnappyCodec
    from snappier_tpu_torch.format import oracle
    from snappier_tpu_torch.format.crc32c import crc32c, mask_crc
    from snappier_tpu_torch.format.varint import write_varint
    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import crc32c as crc
    from snappier_tpu_torch.ops.best_match import exact_candidates
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc
    from snappier_tpu_torch.ops.cuda import watch
    from snappier_tpu_torch.runtime import block, native, prescan

    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)

    # --- 0. liveness, before anything else is built ------------------------
    errs_watch, watch_launches, watch_t, watch_plain_ms = phase_liveness(torch, watch, _build)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built {sorted(_build.SOURCES)} in {time.perf_counter() - t0:.2f} s")
    encode_ptxas = ptxas_figures(_build.BUILD_LOG.get("encode", ""), "encode_kernel")
    # The probe's row walks and the sort's cluster: no stack, no spill.
    probe_ptxas = ptxas_figures(_build.BUILD_LOG.get("probe", ""), "probe_kernel")
    bitonic_ptxas = ptxas_figures(_build.BUILD_LOG.get("bitonic_probe", ""), "bitonic")
    print(json.dumps({"probe_ptxas": probe_ptxas, "bitonic_ptxas": bitonic_ptxas}))
    check(len(probe_ptxas) == 1 and len(bitonic_ptxas) == 1
          and all(f["stack"] == f["spill_stores"] == f["spill_loads"] == 0
                  for f in probe_ptxas + bitonic_ptxas), "probe or bitonic stack frame or spills")
    decode_ptxas = ptxas_figures(_build.BUILD_LOG.get("decode", ""), "_kernel")
    best_ptxas = ptxas_figures(_build.BUILD_LOG.get("encode_best", ""), "encode_best_kernel")
    crc_ptxas = ptxas_figures(_build.BUILD_LOG.get("crc32c", ""), "crc32c_kernel")

    # --- 2. each kernel against its plain version ------------------------
    errs, decode_streams = phase_kernels(torch, sc, crc, oracle, write_varint, exact_candidates)
    errs["watch"] = errs_watch
    errs["probe"], probe_launches, probe_args, probe_expected = phase_probe(torch, sc, _build)

    # --- 3. the main path at full size ------------------------------------
    dev = torch.device("cuda")
    html = word_mix()
    reps = -(-B * BLOCK // len(html))
    data = np.frombuffer((html * reps)[: B * BLOCK], np.uint8).reshape(B, BLOCK)
    frags = torch.from_numpy(data.copy()).to(dev)
    lengths = torch.full((B,), BLOCK, dtype=torch.int32, device=dev)
    codec = SnappyCodec(with_crc=True)
    torch.cuda.synchronize()

    _build.reset_launches()
    bodies, body_lens, crcs = codec.compress_batch(frags, lengths)
    pre = torch.tensor([0x80, 0x80, 0x04], dtype=torch.uint8, device=dev).expand(B, 3)
    blocks = torch.cat([pre, bodies.to(torch.uint8)], dim=1)
    blocks = torch.nn.functional.pad(blocks, (0, (-blocks.shape[1]) % 1024))
    block_lens = body_lens + 3
    outs, out_lens, derrs = codec.decompress_batch(blocks, block_lens, out_cap=BLOCK)
    torch.cuda.synchronize()
    codec_launches = dict(_build.LAUNCHES)
    print(f"codec path launches: {codec_launches}")
    for k in PATHS["codec"]:
        check(codec_launches.get(k, 0) > 0, f"kernel {k} did not launch on the codec path")

    check(outs.shape == (B, BLOCK) and outs.dtype == torch.int32, "decode output shape")
    check(bool((derrs == 0).all()), "main-path decode errors")
    check(bool((out_lens == BLOCK).all()), "main-path decode lengths")
    check(bool((outs == frags.to(torch.int32)).all()), "main-path round trip differs")
    bl = body_lens.cpu().numpy()
    body_bytes = bodies.to(torch.uint8).cpu().numpy()
    crc_h = crcs.cpu().numpy().view(np.uint32)
    for i in np.linspace(0, B - 1, 8).astype(int):
        check(int(crc_h[i]) == crc32c(data[i]), f"CRC of row {i}")
        blk = write_varint(BLOCK) + body_bytes[i, : bl[i]].tobytes()
        check(oracle.decompress(blk) == data[i].tobytes(), f"oracle decode of row {i}")
    ratio = float(bl.sum()) / (B * BLOCK)
    print(f"main path: {B} x {BLOCK} B round trip exact, ratio {ratio:.4f}")

    framed, flens = codec.frame_batch(frags, lengths)
    fl = flens.cpu().numpy()
    fr = framed.cpu().numpy()
    for i in (0, B - 1):
        row = fr[i, : fl[i]]
        check(row[0] == 0 and int.from_bytes(row[1:4].tobytes(), "little") == fl[i] - 4,
              f"frame header of row {i}")
        check(int.from_bytes(row[4:8].tobytes(), "little") == mask_crc(crc32c(data[i])),
              f"frame CRC of row {i}")
        check(oracle.decompress(row[8:].tobytes()) == data[i].tobytes(), f"frame payload {i}")
    _, _, _, ok = codec.roundtrip_step(frags, lengths)
    check(bool(ok), "roundtrip_step not ok")
    print("frame_batch and roundtrip_step ok")

    # --- 4. timings -----------------------------------------------------------
    plain_codec = SnappyCodec(with_crc=False)
    t_c = cuda_ms(lambda: plain_codec.compress_batch(frags, lengths))
    t_cc = cuda_ms(lambda: codec.compress_batch(frags, lengths))
    t_d = cuda_ms(lambda: codec.decompress_batch(blocks, block_lens, out_cap=BLOCK))
    comp_u8 = blocks.contiguous()
    ms = {
        "encode": cuda_ms(lambda: sc.encode_blocks_bytes(frags, lengths)),
        "decode": cuda_ms(lambda: sc.decode_blocks_bytes(comp_u8, block_lens, BLOCK)),
        "crc32c": cuda_ms(lambda: crc.crc32c_blocks(frags, lengths)),
    }
    k3_by_method = {"512": k3_times(torch, crc, _build, frags, lengths)}
    k3_layout = crc.crc32c_layout(dev)
    print(json.dumps({"card": card, "crc32c_layout": k3_layout, "crc32c_ptxas": crc_ptxas,
                      "crc32c_ms_by_method": k3_by_method}))
    k2_layout = sc.encode_layout(frags)
    print(json.dumps({"card": card, "encode_layout": k2_layout, "encode_ptxas": encode_ptxas}))
    # The layout the redesign is for: at 15 hash bits more than one walk an
    # SM, and the walk's probe group in registers (no stack frame, no spill).
    check(k2_layout["blocks_per_sm"] >= 2,
          f"encode kernel: {k2_layout['blocks_per_sm']} block(s) an SM at 15 hash bits")
    # The decode redesign's layout: three walks (blocks of two warps) an SM at
    # out_cap 65,536, and both walks (decode, best encode) in registers.
    k1_layout = sc.decode_layout(comp_u8, BLOCK)
    print(json.dumps({"card": card, "decode_layout": k1_layout, "decode_ptxas": decode_ptxas,
                      "encode_best_ptxas": best_ptxas}))
    check(k1_layout["blocks_per_sm"] >= 3 and k1_layout["loader"] == "ring",
          f"decode kernel: {k1_layout} at out_cap {BLOCK}")
    for what, figs, count in (("encode", encode_ptxas, 2), ("decode", decode_ptxas, 2),
                              ("encode_best", best_ptxas, 2), ("crc32c", crc_ptxas, 1)):
        check(len(figs) == count, f"ptxas figures for the {count} {what} kernels: {figs}")
        for fig in figs:
            check(all(fig.get(k) == 0 for k in ("stack", "spill_stores", "spill_loads")),
                  f"{what} kernel stack frame or spills: {fig}")
    # bench.py's metric: 2 * uncompressed bytes / (compress + decompress),
    # CRC32C not timed inside compress (bench.py:98-103, :156-160).
    gb = B * BLOCK / 1e9
    combined = 2 * gb / ((t_c + t_d) / 1e3)
    print(json.dumps({
        "card": card, "compress_ms": t_c, "compress_with_crc_ms": t_cc,
        "decompress_ms": t_d, "crc_ms": ms["crc32c"], "combined_gbps": combined,
        "compress_gbps": gb / (t_c / 1e3), "decompress_gbps": gb / (t_d / 1e3),
        "ratio": ratio, "blocks": B,
    }))

    # --- 5. the public facade at full size ------------------------------------
    raw = data.tobytes()
    facade_launches, fast, best = phase_facade(torch, st, block, native, prescan, _build, raw)
    cands = exact_candidates(frags, lengths)
    _, best_lens = sc._encode_best(frags, lengths, cands)
    ms["encode_best"] = cuda_ms(lambda: sc._encode_best(frags, lengths, cands))
    ms["probe"] = cuda_ms(lambda: sc.match_extension_probe(*probe_args))
    # The kernel alone, held to the expected lengths first.
    check(sc.launch_probe(*probe_args).cpu().tolist() == probe_expected.tolist(),
          "probe kernel differs from the golden and planted lengths")
    probe_launch_ms = cuda_ms(lambda: sc.launch_probe(*probe_args))
    probe_graph_ms = graph_ms(lambda: sc.match_extension_probe(*probe_args))
    t_cands = cuda_ms(lambda: exact_candidates(frags, lengths), iters=3)
    facade_ms = {  # host wall-clock per call, transfers and host work included
        "compress_fast_ms": best_host_ms(lambda: st.compress(raw)),
        "compress_best_ms": best_host_ms(lambda: st.compress(raw, level="best")),
        "decompress_fast_ms": best_host_ms(lambda: st.decompress(fast)),
        "decompress_best_ms": best_host_ms(lambda: st.decompress(best)),
    }
    # Where a facade call's host time goes: its stages, each timed alone.
    arr, arr_fast = np.frombuffer(raw, np.uint8), np.frombuffer(fast, np.uint8)
    recs = prescan.scan_fragments(arr_fast)
    rows_fast = prescan.assemble_fragment_rows(arr_fast, recs)
    breakdown = {
        "fragment_rows_ms": best_host_ms(lambda: block._fragment_rows(arr)),
        "prescan_fast_ms": best_host_ms(lambda: prescan.scan_fragments(arr_fast)),
        "assemble_rows_fast_ms": best_host_ms(
            lambda: prescan.assemble_fragment_rows(arr_fast, recs)),
        "decode_rows_fast_ms": best_host_ms(
            lambda: block._decode_rows_device(*rows_fast, BLOCK, dev)),
    }
    print(json.dumps({
        "card": card, "facade_bytes": len(raw), **facade_ms, **breakdown,
        "exact_candidates_ms": t_cands, "encode_best_ms": ms["encode_best"],
        "fast_ratio": len(fast) / len(raw), "best_ratio": len(best) / len(raw),
    }))
    k4_layout, turns = redesign_turns(torch, card, sc, frags, lengths, cands, comp_u8,
                                       block_lens)
    phase_candidates(torch, card, _build, frags, lengths)
    # --- 6. the framing format and the stream layers at full size ---------------
    stream_launches, k3_stream_by_method = phase_streams(torch, card)
    k3_by_method.update(k3_stream_by_method)
    ms["watch"] = watch_t["a_add_salt"]

    # --- 7. the decode-walk ablation and the scan engine at full size ------------
    errs_abl, ablation_launches, ms_abl, plain_abl, abl_extra = phase_ablation(
        torch, card, decode_streams, frags, comp_u8, block_lens)
    errs.update(errs_abl)
    ms.update(ms_abl)
    scan_launches, scan_bodies, scan_lens = phase_scan(
        torch, card, data, frags, lengths, comp_u8, block_lens, bl, crcs)

    # --- 8. block-axis sharding, the encode-walk and pipelined-decode ablation ---
    sharded_launches, sharded_scan_launches = phase_sharded(
        torch, card, data, frags, lengths, bodies, body_lens, scan_bodies, scan_lens)
    errs_enc, enc_launches, ms_enc, plain_enc, enc_body_bytes, enc_extra = (
        phase_encode_ablation(torch, card, decode_streams, frags, lengths, body_lens, comp_u8,
                              block_lens))
    errs.update(errs_enc)
    ms.update(ms_enc)

    # --- 9. the descriptor-driven decode ----------------------------------------
    errs_hy, hybrid_launches, ms_hy, plain_hy, hybrid_extra = phase_hybrid(
        torch, card, decode_streams, frags, comp_u8, block_lens)
    errs.update(errs_hy)
    ms.update(ms_hy)

    # --- 10. the micro-probes ----------------------------------------------------
    errs_mp, micro_launches, ms_mp, plain_mp, work_mp, micro_extra = phase_micro_probes(
        torch, card, frags, lengths, comp_u8, block_lens)
    errs.update(errs_mp)
    ms.update(ms_mp)

    # --- 11. the isolation, branch, cliff and sort probes --------------------------
    (errs_iso, iso_launches, ms_iso, plain_iso, work_iso, sort_ms, cliff_extra,
     bprobe_extra, sort_extra) = phase_isolation(torch, card, comp_u8, block_lens)
    errs.update(errs_iso)
    ms.update(ms_iso)
    work_mp.update(work_iso)

    # --- 12. the fuzz campaigns and the B=2,048 codec check -------------------------
    fuzz_launches = phase_fuzz(torch, card)

    # --- 13. the tools: the rehearsal, the ratio table, a trace on the card ------
    tools_launches = phase_tools(torch, card, codec, frags, lengths, ms)

    f1, l1 = torch.from_numpy(data[:1].copy()), torch.from_numpy(np.array([BLOCK], np.int32))
    c1 = torch.from_numpy(comp_u8[:1].cpu().numpy())
    cl1 = block_lens[:1].cpu()
    cand1 = cands[:1].cpu()
    probe_host = [x.cpu() for x in probe_args]
    plain_ms = {
        "encode": host_ms(lambda: sc.encode_blocks_plain(f1, l1, sc.HASH_BITS, 32)),
        "decode": host_ms(lambda: sc.decode_blocks_plain(c1, cl1, BLOCK)),
        "crc32c": host_ms(lambda: crc.crc32c_blocks_plain(f1, l1)),
        "encode_best": host_ms(lambda: sc.encode_best_plain(f1, l1, cand1, 32)),
        "probe": host_ms(lambda: sc.match_extension_probe_plain(*probe_host)),
        "watch": watch_plain_ms, **plain_abl, **plain_enc, **plain_hy, **plain_mp, **plain_iso,
    }
    plain_rows = {"encode": 1, "decode": 1, "crc32c": 1, "encode_best": 1,
                  "probe": len(probe_expected), "watch": watch.SHAPE[0],
                  **{k: 1 for k in (*plain_abl, *plain_enc, *plain_hy, *plain_mp, *plain_iso)}}
    n_in = B * BLOCK
    n_body = int(bl.sum())
    n_best = int(best_lens.sum())
    # The probe needs the compared bytes of each row: the match and the
    # first differing byte on both sides, within the row.
    _, p_ats, _, p_ns = (x.cpu().numpy().astype(np.int64) for x in probe_args)
    compared = int((2 * np.minimum(probe_expected + 1, p_ns - p_ats)).sum())
    n_rows = len(probe_expected)
    moved = {  # bytes each kernel must read once and write once at these shapes
        "encode": n_in + 4 * B + n_body + 4 * B,  # fragments, lengths -> bodies, lengths
        "decode": n_body + 3 * B + 4 * B + n_in + 8 * B,  # blocks, lengths -> bytes, len, err
        "crc32c": n_in + 4 * B + 4 * B,  # fragments, lengths -> CRCs
        # fragments, lengths, int32 candidates -> bodies, lengths
        "encode_best": n_in + 4 * B + 4 * n_in + n_best + 4 * B,
        "probe": compared + 12 * n_rows + 4 * n_rows,  # bytes, 3 args -> lengths
        "watch": 2 * 4 * watch.SHAPE[0] * watch.SHAPE[1],  # int32 words in, words out
    }
    # The ablation variants and the descriptor-driven forms do the decode
    # kernel's work on the same blocks.
    moved.update({k: moved["decode"] for k in (*plain_abl, "decode_pipe", "decode_pipe2",
                                               *plain_hy)})
    # The encode ablation does the encode kernel's work; each variant writes
    # its own bodies.
    moved.update({k: n_in + 4 * B + n + 4 * B for k, n in enc_body_bytes.items()})
    moved.update({k: w[0] for k, w in work_mp.items()})
    # Operations: at least one 32-bit integer step per input byte (a hash,
    # table or candidate step; a decoded byte's store; a compared byte), at
    # the card's 32-bit non-tensor peak. The byte term is the larger one.
    ops = {"encode": n_in, "decode": n_in, "crc32c": n_in, "encode_best": n_in,
           "probe": compared, "watch": watch.SHAPE[0] * watch.SHAPE[1],
           **{k: n_in for k in (*plain_abl, *plain_enc, *plain_hy)},
           **{k: w[1] for k, w in work_mp.items()}}
    # One PyTorch call computes what the liveness kernel does (torch.add);
    # none computes Snappy, CRC32C or a match length. torch.sort stands
    # beside bitonic as the JAX tool's lax.sort does: a full sort, not the
    # same function.
    library_ms = {"watch": watch_t["a_torch_add"], "bitonic": sort_ms}
    by_path = {"liveness": watch_launches, "probe": probe_launches, "codec": codec_launches,
               "facade": facade_launches, "stream": stream_launches,
               "ablation": ablation_launches, "scan": scan_launches,
               "sharded": sharded_launches, "sharded_scan": sharded_scan_launches,
               "encode_ablation": enc_launches, "hybrid": hybrid_launches,
               "micro_probes": micro_launches, "isolation": iso_launches,
               "fuzz": fuzz_launches, "tools": tools_launches}
    rows = []
    for k, (kname, source, replaces) in KERNELS.items():
        t_bytes = moved[k] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[k] / INT32_OPS_PER_S * 1e3
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(p.get(k, 0) for p in by_path.values()),
            "launches_by_path": {p: n[k] for p, n in by_path.items() if n.get(k)},
            "max_abs_err": errs[k], "ms": ms[k],
            "plain_ms": plain_ms[k], "plain_rows": plain_rows[k], "plain_device": "cpu",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": moved[k], "bound_ops": ops[k], "library_ms": library_ms.get(k),
        })
        if k == "watch":
            rows[-1]["ms_by_method"] = watch_t
        if k == "encode":
            rows[-1]["layout"] = {**k2_layout, "ptxas": encode_ptxas}
        if k == "decode":
            rows[-1]["layout"] = {**k1_layout, "ptxas": decode_ptxas}
            rows[-1]["ms_in_turns"] = {n: turns[n] for n in ("decode", "v1")}
        if k == "crc32c":
            rows[-1]["ms_by_method"] = k3_by_method
            rows[-1]["layout"] = {**k3_layout, "ptxas": crc_ptxas}
        if k in abl_extra:
            rows[-1].update(abl_extra[k])
        if k in enc_extra:
            rows[-1].update(enc_extra[k])
        if k == "encode_best":
            rows[-1]["layout"] = {**k4_layout, "ptxas": best_ptxas}
            rows[-1]["ms_in_turns"] = {"encode_best": turns["encode_best"]}
        if k in hybrid_extra:
            rows[-1].update(hybrid_extra[k])
        if k == "cliff":
            rows[-1].update(cliff_extra)
        if k in micro_extra:
            rows[-1].update(micro_extra[k])
        if k == "bprobe":
            rows[-1].update(bprobe_extra)
        if k == "probe":
            # The floor: the longest walk's steps, each at least one
            # dependent load, at this run's chase link (phase 11).
            steps = probe_walk_steps(probe_expected, p_ats, p_ns)
            link_ns = cliff_extra["chase"]["ns_per_step"]
            rows[-1].update({"ms_launch": probe_launch_ms, "ms_graph": probe_graph_ms,
                             "ptxas": probe_ptxas,
                             "walk_steps_max": int(steps.max()), "chase_link_ns": link_ns,
                             "walk_floor_ms": int(steps.max()) * link_ns * 1e-6})
        if k == "bitonic":
            rows[-1].update({"ptxas": bitonic_ptxas, **sort_extra})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the first import, "
          "the kernels' build included")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
