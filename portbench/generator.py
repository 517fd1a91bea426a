"""The one traffic generator: reads a mix's data file
(``portbench/traffic/<mix>.json``) and makes its files from a seed.

A mix is a list of files, each with a length and a model:

* ``random``: uniform random bytes (already-compressed media);
* ``phrases``: a two-level Zipf model. A vocabulary of ``words`` tokens
  (letters of ``alphabet``, lengths around ``word_len``, each followed by a
  separator drawn from ``seps``; ``fixed`` tokens such as markup tags lead
  the ranks) is drawn into ``phrases`` phrases of ``phrase_len`` tokens,
  and the text is a Zipf sequence of phrases (exponent ``phrase_zipf``).
  Phrases of one token make a plain word model;
* ``repeat``: another file of the mix, ``times`` over (``html_x_4``).

Every seed gives the same files at the same lengths and the same
vocabularies; the seed draws only the text. Vocabularies come from a CPU
generator (a few thousand tokens); the bulk draws run on the target device
in a few large calls.
"""

from __future__ import annotations

import hashlib
import json
import pathlib

import torch

HERE = pathlib.Path(__file__).resolve().parent
CHUNK = 1 << 24  # output bytes assembled per call


def load_mix(name: str, root: pathlib.Path = HERE) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def subseed(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of one run."""
    h = hashlib.blake2b(repr((int(seed),) + parts).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _zipf_cdf(n: int, s: float) -> torch.Tensor:
    w = torch.arange(1, n + 1, dtype=torch.float64).pow(-s)
    return (w.cumsum(0) / w.sum()).to(torch.float32)


def _vocabulary(p: dict, g: torch.Generator) -> list[bytes]:
    alphabet = p["alphabet"].encode("latin-1") if isinstance(p["alphabet"], str) else bytes(
        range(p["alphabet"][0], p["alphabet"][1] + 1))
    n = p["words"]
    lo, hi = p["word_len"]
    lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
    letters = torch.randint(0, len(alphabet), (sum(lens),), generator=g).tolist()
    seps = [s.encode("latin-1") for s, _ in p["seps"]]
    sep_w = torch.tensor([w for _, w in p["seps"]], dtype=torch.float64)
    sep_ix = torch.multinomial(sep_w, n, replacement=True, generator=g).tolist()
    if p.get("short_first"):  # the most frequent words are the shortest, as in prose
        lens.sort()
    words, at = [], 0
    for ln, si in zip(lens, sep_ix):
        words.append(bytes(alphabet[c] for c in letters[at : at + ln]) + seps[si])
        at += ln
    return [t.encode("latin-1") for t in p.get("fixed", [])] + words


def _phrase_table(p: dict, g: torch.Generator, device) -> tuple[torch.Tensor, ...]:
    """(bytes of every phrase end to end, start of each, length of each)."""
    words = _vocabulary(p, g)
    wcdf = _zipf_cdf(len(words), p["word_zipf"])
    lo, hi = p["phrase_len"]
    counts = torch.randint(lo, hi + 1, (p["phrases"],), generator=g)
    ids = torch.searchsorted(wcdf, torch.rand(int(counts.sum()), generator=g)).clamp(
        max=len(words) - 1).tolist()
    phrases, at = [], 0
    for c in counts.tolist():
        phrases.append(b"".join(words[i] for i in ids[at : at + c]))
        at += c
    lens = torch.tensor([len(x) for x in phrases], dtype=torch.int64)
    starts = lens.cumsum(0) - lens
    buf = torch.frombuffer(bytearray(b"".join(phrases)), dtype=torch.uint8)
    return buf.to(device), starts.to(device), lens.to(device)


def _phrases(p: dict, n: int, name: str, seed: int, device) -> torch.Tensor:
    """``n`` bytes of the phrase model. The vocabulary and the phrases are
    the file's own, the same for every seed, as a language is; the seed
    draws the text."""
    buf, starts, lens = _phrase_table(p, _gen(subseed(0, name, "vocab"), "cpu"), device)
    cdf = _zipf_cdf(len(lens), p["phrase_zipf"]).to(device)
    g = _gen(subseed(seed, name, "text"), device)
    p_each = torch.diff(cdf.double(), prepend=cdf.new_zeros(1).double())
    mean = float((lens.double() * p_each).sum())
    out = torch.empty(n, dtype=torch.uint8, device=device)
    done = 0
    while done < n:  # whole draws of phrases, CHUNK bytes at a time
        want = min(CHUNK, n - done)
        k = int(want / mean * 1.25) + 16
        ids = torch.searchsorted(cdf, torch.rand(k, generator=g, device=device)).clamp(
            max=len(lens) - 1)
        plen = lens[ids]
        ends = plen.cumsum(0)
        take = min(want, int(ends[-1]))
        t = torch.arange(take, device=device)
        d = torch.searchsorted(ends, t, right=True)
        out[done : done + take] = buf[starts[ids[d]] + t - (ends[d] - plen[d])]
        done += take
    return out


def files(mix: dict, seed: int, copies: int, device) -> dict[str, torch.Tensor]:
    """Every file of the mix as uint8 [copies, length] on ``device``; copy
    c of each file is drawn independently of the others."""
    out = {}
    for f in mix["files"]:
        name, n, model = f["name"], f["length"], f["model"]
        if model == "repeat":
            out[name] = out[f["of"]].repeat(1, f["times"])[:, :n].contiguous()
            continue
        if model == "random":
            g = _gen(subseed(seed, name), device)
            out[name] = torch.randint(0, 256, (copies, n), generator=g, device=device,
                                      dtype=torch.uint8)
        elif model == "phrases":
            out[name] = _phrases(f["params"], copies * n, name, seed, device).view(copies, n)
        else:
            raise ValueError(f"unknown model {model!r} for {name}")
        if out[name].shape != (copies, n):
            raise ValueError(f"{name}: made {tuple(out[name].shape)}, wanted {(copies, n)}")
    return out


def rows_per_copy(mix: dict, fragment: int) -> int:
    return sum(-(-f["length"] // fragment) for f in mix["files"])


def fragment_rows(made: dict[str, torch.Tensor], mix: dict, fragment: int,
                  rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``rows`` rows of the files cut into ``fragment``-byte
    pieces with their true lengths, copy after copy, each copy's files in
    the mix's order: (uint8 [rows, fragment] zero-padded, int32 [rows])."""
    per = rows_per_copy(mix, fragment)
    copies = next(iter(made.values())).shape[0]
    if copies * per < rows:
        raise ValueError(f"{copies} copies give {copies * per} rows, not {rows}")
    dev = next(iter(made.values())).device
    out = torch.zeros((copies, per, fragment), dtype=torch.uint8, device=dev)
    lens = torch.zeros(per, dtype=torch.int32)
    r = 0
    for f in mix["files"]:
        data, n = made[f["name"]], f["length"]
        for a in range(0, n, fragment):
            w = min(fragment, n - a)
            out[:, r, :w] = data[:, a : a + w]
            lens[r] = w
            r += 1
    flat = out.view(copies * per, fragment)[:rows]
    return flat, lens.repeat(copies)[:rows].to(dev)


def concatenated(made: dict[str, torch.Tensor], mix: dict) -> torch.Tensor:
    """Copy after copy, each copy's files end to end: uint8 [copies * sum]."""
    copies = next(iter(made.values())).shape[0]
    per = sum(f["length"] for f in mix["files"])
    dev = next(iter(made.values())).device
    out = torch.empty((copies, per), dtype=torch.uint8, device=dev)
    a = 0
    for f in mix["files"]:
        out[:, a : a + f["length"]] = made[f["name"]]
        a += f["length"]
    return out.view(-1)
