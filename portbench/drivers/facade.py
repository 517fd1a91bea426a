"""Driver of the public one-shot facade: ``snappier_tpu_torch.compress(obj,
level=...)`` on host-resident objects.

Set-up concatenates the traffic's files, copy after copy, and cuts
``pool_objects`` objects of ``object_bytes`` bytes from the front; they
live on the host as ``bytes``, as a caller's buffers do. One warm-up call
runs the whole path once. The window is one caller sending calls back to
back over the pool in turn, each call timed from its start until its
``bytes`` are returned and each call a phase of its own. The window
closes after the first call that ends ``seconds`` or more after it opened.

The check takes ``check_calls`` of the window's streams, drawn from the
seed by reservoir sampling, and decodes each whole, preamble included,
against the object it was made from.
"""

from __future__ import annotations

import time

import torch

from portbench import generator
from portbench.sample import Reservoir
from portbench.reference import control, snappy_plain, snappy_torch


class Program:
    """The system under test: the block facade at the configured level."""

    def __init__(self, cfg: dict, device):
        import snappier_tpu_torch

        self.st, self.level, self.device = snappier_tpu_torch, cfg["level"], device

    def compress(self, obj: bytes) -> bytes:
        return self.st.compress(obj, level=self.level, device=self.device)


class Control:
    """The control (:mod:`portbench.reference.control`): the object cut
    into 64 KiB rows, each chunk-encoded with a ``key_bits``-bit hash
    trusted (exact keys where None), the bodies joined behind one varint
    length."""

    def __init__(self, cfg: dict, device, key_bits: int | None = 16):
        self.device, self.key_bits = device, key_bits

    def compress(self, obj: bytes) -> bytes:
        n, F = len(obj), snappy_plain.BLOCK_SIZE
        rows = -(-n // F)
        flat = torch.zeros(rows * F, dtype=torch.uint8)
        flat[:n] = torch.frombuffer(bytearray(obj), dtype=torch.uint8)
        lens = torch.full((rows,), F, dtype=torch.int64)
        lens[-1] = n - (rows - 1) * F
        bodies, body_lens = control.chunk_encode(flat.view(rows, F).to(self.device),
                                                 lens.to(self.device), self.key_bits)
        host, bl = bodies.cpu().numpy(), body_lens.cpu().tolist()
        return snappy_plain.varint(n) + b"".join(host[i, : bl[i]].tobytes() for i in range(rows))


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, program, rng, span):
        self.cfg, self.device, self.prog, self.span = cfg, device, program, span
        S, N = cfg["object_bytes"], cfg["pool_objects"]
        per = sum(f["length"] for f in mix["files"])
        made = generator.files(mix, seed, -(-S * N // per), device)
        flat = generator.concatenated(made, mix)[: S * N].view(N, S).cpu().numpy()
        del made
        self.objects = [flat[i].tobytes() for i in range(N)]
        self.prog.compress(self.objects[0])
        self.kept = Reservoir(cfg["check_calls"], rng)
        self.phases, self.calls, self.attempted = [], [], 0

    def window(self, seconds: float) -> None:
        start = time.perf_counter()
        i = 0
        while True:
            obj = self.objects[i % len(self.objects)]
            t0 = time.perf_counter()
            with self.span("phase.compress"), self.span("call"):
                out = self.prog.compress(obj)
            t1 = time.perf_counter()
            rec = {"kind": "compress", "t0": t0, "t1": t1, "calls": 1,
                   "bytes_in": len(obj), "bytes_out": len(out)}
            self.phases.append(rec)
            self.calls.append(rec)
            self.kept.offer(lambda i=i, out=out: (i % len(self.objects), out))
            self.attempted += 1
            i += 1
            if t1 - start >= seconds:
                break

    def free_program(self) -> None:
        self.prog = None

    def check(self) -> tuple[dict, int]:
        bad = 0
        for i, stream in self.kept.items:
            obj = self.objects[i]
            try:
                n, used = snappy_plain.read_varint(stream)
            except snappy_plain.CorruptStream:
                bad += 1
                continue
            body = stream[used:]
            if n != len(obj) or len(stream) > snappy_plain.max_compressed_length(len(obj)):
                bad += 1
                continue
            dev = self.device
            comp = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)[None, :]
            plain = torch.frombuffer(bytearray(obj), dtype=torch.uint8).to(dev)[None, :]
            good = snappy_torch.check_rows(comp, torch.tensor([len(body)], device=dev), plain,
                                           torch.tensor([n], device=dev), block_rows=1)
            bad += not bool(good.all())
        unchecked = int(not self.kept.items)
        return {"bad_streams": (bad, 0), "unchecked_calls": (unchecked, 0)}, bad
