"""Driver of the device-resident batch codec: ``SnappyCodec`` (greedy
encode, decode) on rows already on the card.

Set-up cuts the traffic's files into ``fragment``-byte rows and keeps a
pool of ``pool_batches`` distinct batches of ``rows_per_call`` rows on the
device, each larger than the card's 50 MB L2. Each pool batch is
compressed once (the warm-up of the compress shape), and those streams,
each behind the harness's own varint preamble, are the inputs of the
decompress calls, which are warmed up too.

The window alternates a compress phase of ``compress_calls_per_phase``
calls and a decompress phase of ``decompress_calls_per_phase`` calls,
taking the pool batches in turn. A phase enqueues its calls and ends in
one device synchronisation, so the phases tile the window and a stall
anywhere lands in a phase's time. The window closes after the first
decompress phase that ends ``seconds`` or more after the window opened.

The check decodes every row of ``check_calls`` compress calls and compares
every row of as many decompress calls, the calls drawn from the seed by
reservoir sampling over the window.
"""

from __future__ import annotations

import time

import torch

from portbench import generator
from portbench.sample import Reservoir
from portbench.reference import control, snappy_torch

PRE_WIDTH = 4  # room for a row's varint preamble (at most 3 bytes at 64 KiB)


class Program:
    """The system under test: ``SnappyCodec`` with its defaults, without
    the framing CRC."""

    def __init__(self, cfg: dict, device):
        from snappier_tpu_torch import SnappyCodec

        self.codec = SnappyCodec(fragment_size=cfg["fragment"], with_crc=False, device=device)
        self.fragment = cfg["fragment"]

    def compress(self, frags, lengths):
        """-> (word-packed bodies int32 [B, W // 4], body lengths [B])"""
        packed, body_lens, _ = self.codec.compress_batch_packed(frags, lengths)
        return packed, body_lens

    def decompress(self, comp, comp_lens):
        """-> (word-packed rows int32 [B, fragment // 4], lengths, errors)"""
        return self.codec.decompress_batch(comp, comp_lens, out_cap=self.fragment, packed=True)


class Control:
    """The control (:mod:`portbench.reference.control`): the chunk encoder
    that trusts a ``key_bits``-bit hash (exact keys where None), and the
    reference decoder."""

    def __init__(self, cfg: dict, device, key_bits: int | None = 16):
        self.fragment, self.key_bits = cfg["fragment"], key_bits

    def compress(self, frags, lengths):
        bodies, body_lens = control.chunk_encode(frags, lengths, self.key_bits)
        pad = (-bodies.shape[1]) % 4
        bodies = torch.nn.functional.pad(bodies, (0, pad))
        return bodies.view(torch.int32), body_lens

    def decompress(self, comp, comp_lens):
        n, pre = control.read_preambles(comp)
        C = comp.shape[1]
        cols = torch.arange(C - 3, device=comp.device)[None, :] + pre[:, None]
        body = comp.gather(1, cols.clamp(max=C - 1))
        body_lens = comp_lens.to(torch.int64) - pre
        out, ok = snappy_torch.decode_bodies(body, body_lens, n, self.fragment)
        errs = (~ok).to(torch.int32)
        return out.view(torch.int32), torch.where(ok, n, 0).to(torch.int32), errs


def preamble_lengths(lengths: torch.Tensor) -> torch.Tensor:
    n = lengths.to(torch.int64)
    return 1 + (n >= 1 << 7).long() + (n >= 1 << 14).long()


def with_preambles(bodies: torch.Tensor, body_lens: torch.Tensor, lengths: torch.Tensor):
    """Whole blocks: each row's varint length, then its body: (uint8
    [B, PRE_WIDTH + W], int32 [B])."""
    B, W = bodies.shape
    n = lengths.to(torch.int64)
    pre = preamble_lengths(lengths)
    out = torch.zeros((B, PRE_WIDTH + W), dtype=torch.uint8, device=bodies.device)
    digits = [(n & 0x7F) | 0x80, ((n >> 7) & 0x7F) | 0x80, (n >> 14) & 0x7F]
    for k in (1, 2, 3):
        rows = torch.nonzero(pre == k).squeeze(1)
        if len(rows) == 0:
            continue
        head = torch.stack(digits[:k], dim=1)[rows]
        head[:, k - 1] &= 0x7F
        out[rows, :k] = head.to(torch.uint8)
        out[rows, k : k + W] = bodies[rows]
    return out, (body_lens.to(torch.int64) + pre).to(torch.int32)


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, program, rng, span):
        self.cfg, self.device, self.prog, self.span = cfg, device, program, span
        F, rows, P = cfg["fragment"], cfg["rows_per_call"], cfg["pool_batches"]
        copies = -(-rows * P // generator.rows_per_copy(mix, F))
        made = generator.files(mix, seed, copies, device)
        frags, lens = generator.fragment_rows(made, mix, F, rows * P)
        del made
        self.pool = [(frags[i * rows : (i + 1) * rows], lens[i * rows : (i + 1) * rows])
                     for i in range(P)]
        self.pool_bytes = [int(ln.sum()) for _, ln in self.pool]
        self.pool_pre = [int(preamble_lengths(ln).sum()) for _, ln in self.pool]
        self.blocks = []
        for fr, ln in self.pool:  # warm-up of the compress shape, and the decompress inputs
            packed, body_lens = self.prog.compress(fr, ln)
            bodies = packed.contiguous().view(torch.uint8)
            self.blocks.append(with_preambles(bodies, body_lens, ln))
        self.block_bytes = [int(cl.sum()) for _, cl in self.blocks]
        # the window keeps check_calls outputs of each kind alive: hold as
        # many here, so that the allocator has their memory before it opens
        held = [(self.prog.compress(*self.pool[i % P]),
                 self.prog.decompress(*self.blocks[i % P])) for i in range(cfg["check_calls"] + 1)]
        self._sync()
        del held
        self.kept = {"compress": Reservoir(cfg["check_calls"], rng),
                     "decompress": Reservoir(cfg["check_calls"], rng)}
        self.phases, self.calls, self.attempted = [], [], 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _phase(self, kind: str, n_calls: int, turn: int) -> int:
        P = len(self.pool)
        t0 = time.perf_counter()
        body_lens, bytes_in, bytes_out = [], 0, 0
        with self.span("phase." + kind):
            with self.span("dispatch"):
                for _ in range(n_calls):
                    i = turn % P
                    if kind == "compress":
                        out = self.prog.compress(*self.pool[i])
                        body_lens.append(out[1])
                        bytes_in += self.pool_bytes[i]
                        bytes_out += self.pool_pre[i]
                    else:
                        out = self.prog.decompress(*self.blocks[i])
                        bytes_in += self.block_bytes[i]
                        bytes_out += self.pool_bytes[i]
                    self.kept[kind].offer(lambda i=i, out=out: (i, out))
                    turn += 1
            with self.span("sync"):
                self._sync()
        t1 = time.perf_counter()
        self.attempted += n_calls
        self.phases.append({"kind": kind, "t0": t0, "t1": t1, "calls": n_calls,
                            "bytes_in": bytes_in, "bytes_out": bytes_out, "_body_lens": body_lens})
        return turn

    def window(self, seconds: float) -> None:
        start = time.perf_counter()
        turn_c = turn_d = 0
        while True:
            turn_c = self._phase("compress", self.cfg["compress_calls_per_phase"], turn_c)
            turn_d = self._phase("decompress", self.cfg["decompress_calls_per_phase"], turn_d)
            if time.perf_counter() - start >= seconds:
                break
        for p in self.phases:  # compressed bytes are read once the window is over
            p["bytes_out"] += sum(int(x.sum()) for x in p.pop("_body_lens"))

    def free_program(self) -> None:
        self.blocks = None
        self.prog = None

    def check(self) -> tuple[dict, int]:
        """{name: (value, limit)} and the number of checked calls found
        wrong."""
        bad_c = bad_d = failed = 0
        for i, (packed, body_lens) in self.kept["compress"].items:
            fr, ln = self.pool[i]
            bodies = packed.contiguous().view(torch.uint8)
            good = snappy_torch.check_rows(bodies, body_lens, fr, ln)
            bound = (body_lens.to(torch.int64) + preamble_lengths(ln)
                     <= 32 + ln.to(torch.int64) + ln.to(torch.int64) // 6)
            n_bad = int((~(good & bound)).sum())
            bad_c += n_bad
            failed += n_bad > 0
        for i, (outs, out_lens, errs) in self.kept["decompress"].items:
            fr, ln = self.pool[i]
            got = outs.contiguous().view(torch.uint8)
            col = torch.arange(fr.shape[1], device=fr.device)[None, :]
            same = torch.where(col < ln[:, None], got == fr, True).all(1)
            good = same & (errs == 0) & (out_lens.to(torch.int64) == ln.to(torch.int64))
            n_bad = int((~good).sum())
            bad_d += n_bad
            failed += n_bad > 0
        unchecked = sum(not r.items for r in self.kept.values())
        return {"bad_compressed_rows": (bad_c, 0), "bad_decoded_rows": (bad_d, 0),
                "unchecked_kinds": (unchecked, 0)}, failed
