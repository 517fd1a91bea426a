"""Parity of the port's batched codec (``snappier_tpu_torch.models.codec``)
with the JAX ``SnappyCodec(kernel="scalar")``, whose Pallas kernels run in
interpret mode on the CPU. Both get the same numpy inputs; tolerance is
exact equality. Bytes past each row's length are unspecified on both sides
and never compared.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snappier_tpu.constants as ref_constants
import snappier_tpu.format.crc32c as ref_crc
from snappier_tpu.models.codec import SnappyCodec as JaxCodec
from snappier_tpu.models.codec import compact_words as jax_compact_words
import snappier_tpu_torch.constants as port_constants
import snappier_tpu_torch.format.crc32c as port_crc
from snappier_tpu_torch import SnappyCodec
from snappier_tpu_torch.convert import CONFIG_KEYS, codec_from_reference
from snappier_tpu_torch.models.codec import compact_words, pack_rows
from snappier_tpu_torch.ops.cuda.crc32c import kernel_tables
from snappier_tpu_torch.utils import profiling
from tests.torch_cases import html_like

F = 2048


def _batch(F, seed=0):
    """Markup, incompressible, zero, short and empty rows, with random
    garbage past each length."""
    rng = np.random.default_rng(seed)
    lens = np.array([F, F - 11, F, F, 100, 0], np.int32)
    frags = rng.integers(0, 256, (len(lens), F)).astype(np.int32)
    frags[0] = html_like(F, seed)
    frags[1, : F - 11] = html_like(F - 11, seed + 1)
    frags[3] = 0
    frags[4, :100] = html_like(100, seed + 2)
    return frags, lens


def _codecs(F, with_crc=True, **kw):
    jax_codec = JaxCodec(fragment_size=F, with_crc=with_crc, kernel="scalar", **kw)
    port = SnappyCodec(fragment_size=F, with_crc=with_crc, device="cpu", **kw)
    return jax_codec, port


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows_equal(a, b, lens):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    for i, n in enumerate(_np(lens)):
        assert (a[i, :n] == b[i, :n]).all(), i


@pytest.mark.parametrize("F,with_crc", [(2048, True), (65536, True), (2048, False)])
def test_compress_batch_matches_jax(F, with_crc):
    frags, lens = _batch(F) if F == 2048 else (
        np.stack([html_like(F, 5), np.zeros(F, np.int32)]).astype(np.int32),
        np.array([F, F - 1], np.int32))
    jc, pc = _codecs(F, with_crc)
    jb, jl, jcrc = jc.compress_batch(jnp.asarray(frags), jnp.asarray(lens))
    pb, pl, pcrc = pc.compress_batch(frags, lens)
    assert pb.dtype == torch.int32 and pl.dtype == torch.int32 and pcrc.dtype == torch.int32
    assert (_np(pl) == _np(jl)).all()
    assert (_np(pcrc) == _np(jcrc)).all()
    _rows_equal(pb, jb, jl)


def test_compress_batch_packed_matches_jax():
    frags, lens = _batch(F)
    jc, pc = _codecs(F)
    jw, jl, jcrc = jc.compress_batch_packed(jnp.asarray(frags), jnp.asarray(lens))
    pw, pl, pcrc = pc.compress_batch_packed(frags, lens)
    assert pw.dtype == torch.int32
    assert (_np(pl) == _np(jl)).all() and (_np(pcrc) == _np(jcrc)).all()
    _rows_equal(_np(pw).view(np.uint8), _np(jw).view(np.uint8), jl)


@pytest.mark.parametrize("packed", [False, True])
def test_decompress_batch_matches_jax(packed):
    frags, lens = _batch(F)
    jc, pc = _codecs(F)
    jb, jl, _ = jc.compress_batch(jnp.asarray(frags), jnp.asarray(lens))
    jb, jl = np.asarray(jb), np.asarray(jl)
    # 3-byte preambles, rows padded to the JAX kernel's 1024-byte tiling.
    pre = np.stack([(lens & 0x7F) | 0x80, ((lens >> 7) & 0x7F) | 0x80, (lens >> 14) & 0x7F],
                   axis=1)
    blocks = np.concatenate([pre, jb], axis=1)
    blocks = np.pad(blocks, ((0, 0), (0, (-blocks.shape[1]) % 1024)))
    blocks[:, 3:][np.arange(blocks.shape[1] - 3)[None, :] >= jl[:, None]] = 0xAB
    ref = jc.decompress_batch(jnp.asarray(blocks), jnp.asarray(jl + 3), packed=packed)
    got = pc.decompress_batch(blocks, jl + 3, packed=packed)
    assert got[0].dtype == torch.int32 and got[0].shape == np.asarray(ref[0]).shape
    assert (_np(got[2]) == _np(ref[2])).all() and (_np(got[2]) == 0).all()
    assert (_np(got[1]) == _np(ref[1])).all()
    out = _np(got[0]).view(np.uint8) if packed else _np(got[0])
    r_out = _np(ref[0]).view(np.uint8) if packed else _np(ref[0])
    _rows_equal(out, r_out, ref[1])
    _rows_equal(out, frags.astype(out.dtype), lens)


def test_frame_batch_matches_jax():
    frags, lens = _batch(F)
    jc, pc = _codecs(F)
    jf, jfl = jc.frame_batch(jnp.asarray(frags), jnp.asarray(lens))
    pf, pfl = pc.frame_batch(frags, lens)
    assert pf.dtype == torch.uint8 and pf.shape == np.asarray(jf).shape
    assert (_np(pfl) == _np(jfl)).all()
    assert _np(pfl)[-1] == 0 and _np(pf)[2, 0] == 1  # empty row; raw fallback
    _rows_equal(pf, jf, jfl)

    jw, jwl = jc.frame_batch_packed(jnp.asarray(frags), jnp.asarray(lens))
    pw, pwl = pc.frame_batch_packed(frags, lens)
    assert pw.shape == np.asarray(jw).shape and (_np(pwl) == _np(jwl)).all()
    _rows_equal(_np(pw).view(np.uint8), _np(jw).view(np.uint8), jwl)


def test_roundtrip_step_matches_jax():
    frags, lens = _batch(F)
    jc, pc = _codecs(F)
    jb, jl, jcrc, jok = jc.roundtrip_step(jnp.asarray(frags), jnp.asarray(lens))
    pb, pl, pcrc, pok = pc.roundtrip_step(frags, lens)
    assert bool(jok) and bool(pok)
    assert (_np(pl) == _np(jl)).all() and (_np(pcrc) == _np(jcrc)).all()
    _rows_equal(pb, jb, jl)
    # A corrupted body must fail the check.
    bad = frags.copy()
    _, _, _, ok = pc.roundtrip_step(bad[:1], np.array([F + 1], np.int32))
    assert not bool(ok)


def test_compact_words_matches_jax():
    rng = np.random.default_rng(4)
    words = rng.integers(-(2**31), 2**31, (5, 64), dtype=np.int64).astype(np.int32)
    wlens = np.array([3, 0, 64, 17, 1], np.int32)
    cap = 96
    ref = np.asarray(jax_compact_words(jnp.asarray(words), jnp.asarray(wlens), cap_words=cap))
    got = compact_words(torch.from_numpy(words), torch.from_numpy(wlens), cap).numpy()
    total = int(wlens.sum())
    assert (got[:total] == ref[:total]).all()
    assert (got == ref).all()


def test_pack_rows_is_little_endian_words():
    rows = torch.tensor([[1, 2, 3, 4, 255, 0, 0, 128]], dtype=torch.int32)
    assert pack_rows(rows).tolist() == [[0x04030201, -(2**31) + 0xFF]]


def test_codec_from_reference_carries_config():
    ref = JaxCodec(fragment_size=8192, with_crc=False, kernel="scalar", hash_bits=13,
                   skip_base=48)
    port = codec_from_reference({k: getattr(ref, k) for k in CONFIG_KEYS}, device="cpu")
    assert [getattr(port, k) for k in CONFIG_KEYS] == [8192, False, 13, 48]
    frags = np.stack([html_like(8192, 8)]).astype(np.int32)
    lens = np.array([8192], np.int32)
    jb, jl, jcrc = ref.compress_batch(jnp.asarray(frags), jnp.asarray(lens))
    pb, pl, pcrc = port.compress_batch(frags, lens)
    assert int(pl[0]) == int(jl[0]) and (_np(pcrc) == 0).all()
    _rows_equal(pb, jb, jl)
    with pytest.raises(KeyError):
        codec_from_reference({"fragment_size": 1024}, device="cpu")


def test_port_tables_equal_reference():
    assert (port_crc.byte_table() == ref_crc.byte_table()).all()
    assert (port_crc.lbit_table() == ref_crc.lbit_table()).all()
    assert (port_crc.zero_crc_table() == ref_crc.zero_crc_table()).all()
    mats = port_crc.shift_matrices(32)
    for k in (0, 1, 7, 16, 31):
        assert (mats[k] == ref_crc._shift_matrix_pow2(k)).all(), k
    tables = kernel_tables()  # the byte table, two shift tables, the combine's matrices
    assert tables.dtype == np.uint32 and tables.shape == (256 + 2 * 1024 + 32 * 32 + 8 * 32,)
    assert (tables[:256] == ref_crc.byte_table()).all()
    for n in (0, 1, 255, 65535, 65536, 1 << 20):
        assert port_constants.greedy_emit_bound(n) == ref_constants.greedy_emit_bound(n)
    for name in ("BLOCK_SIZE", "INPUT_MARGIN_BYTES", "CRC_MASK_DELTA", "MAX_COPY_LENGTH"):
        assert getattr(port_constants, name) == getattr(ref_constants, name)


def test_crc_shift_combines_like_reference():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, 1000, np.uint8).tobytes()
    b = rng.integers(0, 256, 777, np.uint8).tobytes()
    assert port_crc.crc32c_combine(port_crc.crc32c(a), port_crc.crc32c(b), len(b)) == (
        ref_crc.crc32c(a + b))


def test_codec_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SnappyCodec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SnappyCodec(device="cuda")
    assert SnappyCodec(device="cpu").device.type == "cpu"


def test_codec_rejects_unported_engine():
    """Both engines are ported: ``kernel="scan"`` builds the parallel-scan
    codec (tests/test_torch_scan_codec.py holds it against the JAX one); an
    unknown name still raises."""
    assert SnappyCodec(kernel="scan", device="cpu").kernel == "scan"
    assert SnappyCodec(kernel="scalar", device="cpu").kernel == "scalar"
    with pytest.raises(ValueError):
        SnappyCodec(kernel="nope", device="cpu")
    with pytest.raises(ValueError):
        SnappyCodec(fragment_size=65537, device="cpu")


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, found by walking the package, imports
    without JAX, without the reference package, without a card and without
    joining ``torch.distributed``."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import snappier_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(snappier_tpu_torch.__path__,
                                                       "snappier_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for must in ("parallel.mesh", "parallel.distributed", "graft_entry",
                     "ops.cuda.encode_variants", "ops.cuda.decode_variants",
                     "ops.cuda.decode_hybrid", "ops.cuda.hybrid_probes"):
            assert "snappier_tpu_torch." + must in names, must
        assert snappier_tpu_torch.parallel.make_mesh(["cpu"] * 2).size == 2
        import torch.distributed
        assert not torch.distributed.is_initialized()
        snappier_tpu_torch.runtime.native.load()
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "snappier_tpu" or m.startswith("snappier_tpu."))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_imports_neither_jax_nor_reference():
    """No import line of ``chip_smoke.py``, of a ``tools/torch_*.py`` or of a
    module of the port names JAX or the reference package."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = [root / "chip_smoke.py", *sorted((root / "tools").glob("torch_*.py")),
             *sorted((root / "snappier_tpu_torch").rglob("*.py"))]
    names = {f.name for f in files}
    assert {"torch_dist_worker.py", "torch_perf_probe_enc.py", "torch_perf_probe_r4.py",
            "torch_perf_probe_hybrid.py", "torch_fuzz.py", "torch_rehearsal_multihost.py",
            "torch_ratio_table.py", "profiling.py", "graft_entry.py", "mesh.py", "distributed.py",
            "encode_variants.py", "decode_hybrid.py", "hybrid_probes.py"} <= names
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1]
                assert mod != "jax" and not mod.startswith("jax."), (f.name, line)
                assert mod != "snappier_tpu" and not mod.startswith("snappier_tpu."), (f.name, line)


def test_port_format_copies_match_reference(corpus_file):
    """The port's copies of the format layer (oracle codec, varint, CRC32C)
    give the reference's bytes on each corpus file (or its synthetic
    stand-in)."""
    import snappier_tpu.format.oracle as ref_oracle
    import snappier_tpu.format.varint as ref_varint
    import snappier_tpu_torch.format.oracle as port_oracle
    import snappier_tpu_torch.format.varint as port_varint

    _, data = corpus_file
    data = data[:150_000]
    comp = port_oracle.compress(data)
    assert comp == ref_oracle.compress(data)
    assert port_oracle.decompress(comp) == data == ref_oracle.decompress(comp)
    assert port_crc.crc32c(data) == ref_crc.crc32c(data)
    assert port_crc.mask_crc(port_crc.crc32c(data)) == ref_crc.mask_crc(ref_crc.crc32c(data))
    n = len(data)
    assert port_varint.write_varint(n) == ref_varint.write_varint(n)
    assert port_varint.read_varint(comp) == ref_varint.read_varint(comp)


def test_codec_spans(monkeypatch):
    """With spans on, each compress entry point is one ``codec.compress``
    root over ``codec.encode`` (and ``codec.pack`` when it packs), each
    decode one ``codec.decompress``; on the CPU no span carries a device
    time (only a span on the card times its stream)."""
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.spans_reset()
    frags, lens = _batch(F)
    codec = SnappyCodec(fragment_size=F, device="cpu")
    packed, _, _ = codec.compress_batch_packed(frags, lens)
    bodies, body_lens, _ = codec.compress_batch(frags, lens)
    codec.frame_batch(frags, lens)
    pre = np.stack([(lens & 0x7F) | 0x80, ((lens >> 7) & 0x7F) | 0x80, (lens >> 14) & 0x7F],
                   axis=1)
    outs, _, errs = codec.decompress_batch(np.concatenate([pre, bodies.numpy()], axis=1),
                                           body_lens.numpy() + 3, out_cap=F)
    assert (errs == 0).all()
    _rows_equal(outs, frags, lens)
    recs = profiling.spans_snapshot()
    profiling.spans_reset()
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] == -1]
    assert [r["name"] for r in roots] == ["codec.compress"] * 3 + ["codec.decompress"]
    trees = [sorted(r["name"] for r in recs if r["call"] == root["id"] and r is not root)
             for root in roots]
    assert trees == [["codec.encode", "codec.pack"], ["codec.encode"], ["codec.encode"], []]
    for r in recs:
        if r["parent"] != -1:
            up = by_id[r["parent"]]
            assert up["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= up["t1_ns"]
    assert all(r["stream_ms"] is None for r in recs)
    (pack,) = [r for r in recs if r["name"] == "codec.pack"]
    assert pack["nbytes"] == packed.nbytes
