#!/usr/bin/env python3
"""Compressed-size table of the port: every engine over stand-ins for the
11 files of the canonical corpus.

The port's twin of ``tools/ratio_table.py``. The corpus itself is not in the
repository, so each name gets a stand-in at the length the corpus file has
(``LENGTHS``; ``--size N`` sets every length to N): random bytes for the
compressed formats (``.jpeg``, ``.pdf``) and a word mix otherwise, seeded by
the CRC-32 of the name. The sizes are therefore not comparable with the
real corpus's; the ``reference`` column of the JAX tool (the golden
``.snappy`` anchors) waits until the corpus is in the repository.

Columns, each the whole stream with its varint preamble:

* ``oracle``: ``format.oracle.compress``, the port's pure-Python encoder;
* ``native``: ``runtime.native.compress``, the C++ engine (absent when the
  library is unavailable);
* ``scalar``: the greedy encode kernel K2 (``encode_blocks_bytes``), one
  batched call over every file's 64 KiB fragments;
* ``best``: the ``level="best"`` encoder (``encode_blocks_best``: exact
  candidates and the best encode kernel K4), one batched call likewise;
* ``scan``: the parallel-scan engine's ``encode_block``, fragment by
  fragment.

The three device columns run on the card (``--device cuda``, the default,
which raises without one) or through the kernels' plain versions
(``--device cpu``); the tests hold the CPU columns to the JAX package's.

Usage: python3 tools/torch_ratio_table.py [--device cuda|cpu] [--size N]

It prints a JSON line per file, then the markdown table.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import zlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from snappier_tpu_torch.constants import BLOCK_SIZE  # noqa: E402
from snappier_tpu_torch.format import oracle  # noqa: E402
from snappier_tpu_torch.format.varint import write_varint  # noqa: E402
from snappier_tpu_torch.models.codec import resolve_device  # noqa: E402
from snappier_tpu_torch.ops.cuda.scalar_codec import (  # noqa: E402
    encode_blocks_best,
    encode_blocks_bytes,
)
from snappier_tpu_torch.ops.encode import encode_block  # noqa: E402
from snappier_tpu_torch.runtime import native  # noqa: E402

#: The canonical corpus's names and lengths in bytes.
LENGTHS = {
    "alice29.txt": 148481, "asyoulik.txt": 125179, "fireworks.jpeg": 123093,
    "geo.protodata": 118588, "html": 102400, "html_x_4": 409600, "kppkn.gtb": 184320,
    "lcet10.txt": 419235, "paper-100k.pdf": 102400, "plrabn12.txt": 471162,
    "urls.10K": 702087,
}
CORPUS = list(LENGTHS)
WORDS = [b"the", b"quick", b"brown", b"snappy", b"tpu", b"block", b"compress", b"format",
         b"stream", b"<html><body>"]
DEVICE_COLUMNS = ("scalar", "best", "scan")
COLUMNS = ["file", "n", "oracle", "native", *DEVICE_COLUMNS]


def standin(name: str, size: int) -> bytes:
    """Random bytes for the compressed formats (jpeg, pdf), else a word mix,
    seeded by the name's CRC-32."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.endswith((".jpeg", ".pdf")):
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    parts = rng.integers(0, len(WORDS), size // 3)
    return b" ".join(WORDS[i] for i in parts)[:size]


def corpus(size: int | None = None) -> dict[str, bytes]:
    """Every name's stand-in, at its corpus length or at ``size``."""
    return {name: standin(name, size or n) for name, n in LENGTHS.items()}


def _fragments(files: dict[str, bytes]):
    """Every file's 64 KiB fragments as zero-padded rows, and each file's
    (first row, row count, preamble)."""
    spans, rows, lens = {}, [], []
    for name, data in files.items():
        arr = np.frombuffer(data, np.uint8)
        nfrags = max(1, -(-len(arr) // BLOCK_SIZE))
        spans[name] = (len(lens), nfrags, write_varint(len(arr)))
        for i in range(nfrags):
            frag = arr[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE]
            row = np.zeros(BLOCK_SIZE, np.uint8)
            row[: len(frag)] = frag
            rows.append(row)
            lens.append(len(frag))
    return spans, np.stack(rows), np.asarray(lens, np.int32)


def device_streams(files: dict[str, bytes], device="cuda") -> dict[str, dict[str, bytes]]:
    """Each file's stream from each device engine (:data:`DEVICE_COLUMNS`):
    ``scalar`` and ``best`` from one batched call each, ``scan`` a fragment
    at a time."""
    dev = resolve_device(device)
    spans, rows, lens = _fragments(files)
    frags = torch.from_numpy(rows).to(dev)
    lengths = torch.from_numpy(lens).to(dev)
    bodies = {"scalar": encode_blocks_bytes(frags, lengths), "best": encode_blocks_best(frags, lengths)}
    host = {k: (b.to(torch.uint8).cpu().numpy(), bl.cpu().numpy()) for k, (b, bl) in bodies.items()}
    scan = [encode_block(frags[i], int(lens[i])) for i in range(len(lens))]
    host["scan"] = (np.stack([o.to(torch.uint8).cpu().numpy() for o, _ in scan]),
                    np.asarray([int(n) for _, n in scan]))
    out = {}
    for name, (a, k, pre) in spans.items():
        out[name] = {col: pre + b"".join(b[i, : bl[i]].tobytes() for i in range(a, a + k))
                     for col, (b, bl) in host.items()}
    return out


def table(files: dict[str, bytes], device="cuda", streams=None) -> list[dict]:
    """A row per file: its length and each engine's compressed size.
    ``streams`` (:func:`device_streams`' result) saves computing them."""
    streams = streams if streams is not None else device_streams(files, device)
    rows = []
    for name, data in files.items():
        entry = {"file": name, "n": len(data), "oracle": len(oracle.compress(data))}
        if native.available():
            entry["native"] = len(native.compress(data))
        entry.update({col: len(s) for col, s in streams[name].items()})
        rows.append(entry)
    return rows


def markdown(rows: list[dict]) -> str:
    lines = ["| " + " | ".join(COLUMNS) + " |", "|" + "---|" * len(COLUMNS)]
    lines += ["| " + " | ".join(str(e.get(c, "-")) for c in COLUMNS) + " |" for e in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--size", type=int, default=None, help="every stand-in's length in bytes")
    args = ap.parse_args(argv)
    rows = table(corpus(args.size), args.device)
    for e in rows:
        print(json.dumps(e), flush=True)
    print()
    print(markdown(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
