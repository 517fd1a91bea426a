"""The micro-probes' bodies (``snappier_tpu_torch/csrc/hybrid_probes.cuh``,
the sort's cluster in ``csrc/bitonic_probe.cu``'s order too), compiled for
the host with g++ and held against their plain versions in
``snappier_tpu_torch/ops/cuda/hybrid_probes.py`` (which
tests/test_torch_hybrid_probes.py holds against the TPU kernels in
interpret mode).

The bodies are ``__host__ __device__`` functions, so this is the one place
their own logic runs without a GPU. vcopy's and iso's record loops run as
the kernels run them, on a warp of 32 lanes whose values are arrays run in
lock step (``tests/torch_cases.py::ARRAY_WARP``): the batches of 32 records
loaded two batches and planned one batch ahead into the ring of plans after
the image, each record's plan read two records before its body, the stores
predicated on the run's length, scalar's lanes on records. The port never
uses this host build.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np
import pytest

from tests.torch_cases import (
    ARRAY_WARP,
    BATCH_EDGE_COUNTS,
    count_records,
    gxx_library,
    probe_blocks,
    vcopy_edges,
)

SHIM = (r"""
#include <cstring>
#include <vector>

#include "hybrid_probes.cuh"
"""
    + ARRAY_WARP
    + r"""
// The advances as the walk's kernel stages them: `staged` words of
// hp::cliff_staged.
static std::vector<int32_t> staged_advances(const int32_t* adv, int32_t n, int32_t staged) {
  std::vector<int32_t> adv_s(staged);
  for (int32_t i = 0; i < staged; i++) adv_s[i] = hp::cliff_staged(adv, n, i);
  return adv_s;
}

// chain's kernel as it runs: cliff_kernel<kChase>, or <kChainRec> over a
// record buffer from 0 that recs gets.
extern "C" int32_t host_chain(int32_t with_rec, const int32_t* adv, int32_t n, int32_t staged,
                              int32_t start, int32_t R, int32_t* recs) {
  const std::vector<int32_t> adv_s = staged_advances(adv, n, staged);
  if (!with_rec) return hp::cliff_walk<hp::kChase>(adv_s.data(), n, start, R, nullptr);
  std::vector<uint32_t> buf(hp::kRecWords, 0u);
  const int32_t sum = hp::cliff_walk<hp::kChainRec>(adv_s.data(), n, start, R, buf.data());
  for (int i = 0; i < hp::kRecWords; i++) recs[i] = (int32_t)buf[i];
  return sum;
}

// vcopy_kernel's and iso_kernel's work (hp::vcopy_run, hp::iso_run) as
// the kernels run it, on a warp of 32 array lanes, over the image and the
// plan ring after it (the kernels' shared memory); img gets the image;
// returns the warp's sum (iso's with row 0's odd words).
struct Smem {
  std::vector<hp::Words4> words;
  int32_t* img;
  Smem(int32_t* image) : words(hp::kRecordSmemWords / 4), img(image) {
    memcpy(words.data(), img, 4 * hp::kImageWords);
  }
  ~Smem() { memcpy(img, words.data(), 4 * hp::kImageWords); }
  uint32_t* data() { return reinterpret_cast<uint32_t*>(words.data()); }
};

extern "C" int32_t host_vcopy(int32_t mode3d, const int32_t* rec, int32_t* img) {
  Smem smem(img);
  uint32_t* im = smem.data();
  ArrayWarp<32> w;
  ArrayWarp<32>::Lanes<uint32_t> acc{};
  if (mode3d) {
    hp::vcopy_run<true>(w, rec, im, acc);
  } else {
    hp::vcopy_run<false>(w, rec, im, acc);
  }
  uint32_t sum = 0;
  for (int l = 0; l < 32; l++) sum += acc[l];
  return (int32_t)sum;
}

template <int kMode>
static uint32_t host_iso_mode(const int32_t* rec, uint32_t* im) {
  ArrayWarp<32> w;
  ArrayWarp<32>::Lanes<uint32_t> acc{};
  hp::iso_run<kMode>(w, rec, im, acc);
  uint32_t sum = 0;
  for (int l = 0; l < 32; l++) sum += acc[l];
  for (int i = 0; i < hp::kLanes; i++) sum += im[i] & 1u;
  return sum;
}

extern "C" int32_t host_iso(int32_t mode, const int32_t* rec, int32_t* img) {
  Smem smem(img);
  uint32_t* m = smem.data();
  uint32_t sum;
  switch (mode) {
    case hp::kIsoScalar: sum = host_iso_mode<hp::kIsoScalar>(rec, m); break;
    case hp::kIsoDynload: sum = host_iso_mode<hp::kIsoDynload>(rec, m); break;
    case hp::kIsoDynload8: sum = host_iso_mode<hp::kIsoDynload8>(rec, m); break;
    case hp::kIsoStatroll: sum = host_iso_mode<hp::kIsoStatroll>(rec, m); break;
    case hp::kIsoDynroll: sum = host_iso_mode<hp::kIsoDynroll>(rec, m); break;
    default: sum = host_iso_mode<hp::kIsoFull>(rec, m);
  }
  return (int32_t)sum;
}

// The copy probes' shared bytes: the image and the plan ring.
extern "C" int32_t host_copy_smem_bytes() { return 4 * hp::kRecordSmemWords; }

// coissue's rows as the kernel runs them: each row on a warp of 32 array
// lanes, 4 words a lane (hp::coissue_row), kNvec updates an iteration; the
// tile updated in place. Returns the count of odd words.
template <int kNvec>
static uint32_t host_coissue_rows(int32_t iters, int32_t* tile) {
  ArrayWarp<32> w;
  std::vector<int32_t> row(hp::kLanes);
  uint32_t odd = 0;
  for (int r = 0; r < hp::kTileRows; r++) {
    const auto par = hp::coissue_row<kNvec>(w, tile + r * hp::kLanes, iters, row.data());
    for (int l = 0; l < 32; l++) odd += par[l];
    memcpy(tile + r * hp::kLanes, row.data(), sizeof(int32_t) * hp::kLanes);
  }
  return odd;
}

// coissue as the kernel runs it: the scalar chain (hp::coissue_step over
// the scratch at 8-byte strides) and the rows; nvec hp::kCoissueVec the
// rows at 8 updates and no chain (coissue_vec).
extern "C" int32_t host_coissue(int32_t seed, int32_t nvec, int32_t iters, int32_t* tile) {
  uint32_t acc = 0;
  if (nvec != hp::kCoissueVec) {
    uint32_t scratch[hp::kScratchSlots];
    hp::scratch_init(scratch, seed);
    for (uint32_t t = 0; t < (uint32_t)iters; t++) acc += hp::coissue_step(scratch, t);
  }
  switch (nvec) {
    case 0: return (int32_t)(acc + host_coissue_rows<0>(iters, tile));
    case 1: return (int32_t)(acc + host_coissue_rows<1>(iters, tile));
    case 2: return (int32_t)(acc + host_coissue_rows<2>(iters, tile));
    default: return (int32_t)(acc + host_coissue_rows<hp::kVecUpdates>(iters, tile));
  }
}

// bprobe_kernel's work: the scratch in an array of 64 (registers on the
// card), 8,192 blocks of 64 iterations.
template <int kNwhen>
int32_t host_bprobe_n(int32_t seed, int32_t* scratch) {
  uint32_t s[hp::kBprobeBlock];
  const uint32_t acc = hp::bprobe_run<kNwhen>(s, seed);
  for (int i = 0; i < hp::kBprobeBlock; i++) scratch[i] = (int32_t)s[i];
  return (int32_t)acc;
}

extern "C" int32_t host_bprobe(int32_t nwhen, int32_t seed, int32_t* scratch) {
  switch (nwhen) {
    case 0: return host_bprobe_n<0>(seed, scratch);
    case 1: return host_bprobe_n<1>(seed, scratch);
    case 2: return host_bprobe_n<2>(seed, scratch);
    case 3: return host_bprobe_n<3>(seed, scratch);
    case 4: return host_bprobe_n<4>(seed, scratch);
    default: return host_bprobe_n<8>(seed, scratch);
  }
}

extern "C" int32_t host_bprobe_floor(int32_t seed) { return (int32_t)hp::bprobe_floor(seed); }

// cliff_kernel<mode> (hp::kChase: the chase) as it runs: adv staged over
// `staged` words (hp::cliff_staged), the image and its dummy word from
// interpret mode's fill; img gets the image (the chase leaves it as it is).
template <int kMode>
static int32_t host_cliff_mode(const int32_t* adv_s, int32_t n, int32_t start, int32_t R,
                               uint32_t* im) {
  const uint32_t sum = (uint32_t)hp::cliff_walk<kMode>(adv_s, n, start, R, im);
  return (int32_t)(kMode == hp::kChase ? sum : sum + im[0]);
}

extern "C" int32_t host_cliff(int32_t mode, const int32_t* adv, int32_t n, int32_t staged,
                              int32_t start, int32_t R, int32_t* img) {
  const std::vector<int32_t> adv_s = staged_advances(adv, n, staged);
  std::vector<uint32_t> im(hp::kCliffImageWords, hp::kFill);
  const int32_t* a = adv_s.data();
  uint32_t* m = im.data();
  int32_t sum;
  switch (mode) {
    case hp::kCliffWhen1: sum = host_cliff_mode<hp::kCliffWhen1>(a, n, start, R, m); break;
    case hp::kCliffWhen2: sum = host_cliff_mode<hp::kCliffWhen2>(a, n, start, R, m); break;
    case hp::kCliffFori: sum = host_cliff_mode<hp::kCliffFori>(a, n, start, R, m); break;
    case hp::kCliffStore4: sum = host_cliff_mode<hp::kCliffStore4>(a, n, start, R, m); break;
    case hp::kCliffLoad4: sum = host_cliff_mode<hp::kCliffLoad4>(a, n, start, R, m); break;
    default: sum = host_cliff_mode<hp::kChase>(a, n, start, R, m);
  }
  if (mode != hp::kChase) {
    for (int i = 0; i < hp::kImageWords; i++) img[i] = (int32_t)im[i];
  }
  return sum;
}

// bitonic_probe.cu's cluster as it runs: each of hp::kSortCtas CTAs takes
// its runs (what its TMA copies: runs[(r << 10) | i] = x[(r << 13) | (c << 10)
// | i]) and runs the top three stages in its threads' registers, a warp of 32
// array lanes at a time; the transpose stores 16-byte pieces into each CTA's
// tile (after every CTA runs: the first cluster barrier); then, a phase per
// barrier, the tile's three rounds in registers and the last four stages,
// j = 8 through the warp's exchange.
extern "C" void host_bitonic(const int32_t* x, int32_t* keys, int32_t* vals) {
  const ArrayWarp<32> w;
  const int32_t warps = hp::kSortThreads / 32;
  std::vector<int32_t> rk(hp::kSortN), rv(hp::kSortN), ks(hp::kSortN), vs(hp::kSortN);
  for (int32_t c = 0; c < hp::kSortCtas; c++) {
    for (int32_t r = 0; r < 8; r++) {
      memcpy(&rk[c * hp::kSortTile + r * hp::kSortRun], x + (r << 13) + (c << 10),
             4 * hp::kSortRun);
    }
    for (int32_t wi = 0; wi < warps; wi++) {
      hp::bitonic_top(w, c, wi, &rk[c * hp::kSortTile], &rv[c * hp::kSortTile]);
    }
  }
  for (int32_t c = 0; c < hp::kSortCtas; c++) {
    for (int32_t wi = 0; wi < warps; wi++) {
      hp::bitonic_send(w, c, wi, &rk[c * hp::kSortTile], &rv[c * hp::kSortTile],
                       [&](int32_t cta, int32_t i, const int32_t* k, const int32_t* v) {
                         memcpy(&ks[cta * hp::kSortTile + i], k, 16);
                         memcpy(&vs[cta * hp::kSortTile + i], v, 16);
                       });
    }
  }
  for (int32_t c = 0; c < hp::kSortCtas; c++) {
    int32_t* kt = &ks[c * hp::kSortTile];
    int32_t* vt = &vs[c * hp::kSortTile];
    for (int32_t q = 0; q < 3; q++) {
      for (int32_t wi = 0; wi < warps; wi++) {
        hp::bitonic_tile_regs(w, c, wi, kt, vt, hp::kSortTopShift - 3 * q);
      }
    }
    for (int32_t wi = 0; wi < warps; wi++) {
      hp::bitonic_tile_last(w, c, wi, kt, vt, keys, vals);
    }
  }
}

""")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    so = gxx_library(SHIM, tmp_path_factory.mktemp("probe_host"))
    P, I32 = ctypes.c_void_p, ctypes.c_int32
    so.host_chain.argtypes = [I32, P, I32, I32, I32, I32, P]
    so.host_chain.restype = I32
    so.host_vcopy.argtypes = [I32, P, P]
    so.host_vcopy.restype = I32
    so.host_coissue.argtypes = [I32, I32, I32, P]
    so.host_coissue.restype = I32
    so.host_iso.argtypes = [I32, P, P]
    so.host_iso.restype = I32
    so.host_copy_smem_bytes.argtypes = []
    so.host_copy_smem_bytes.restype = I32
    so.host_bprobe.argtypes = [I32, I32, P]
    so.host_bprobe.restype = I32
    so.host_bprobe_floor.argtypes = [I32]
    so.host_bprobe_floor.restype = I32
    so.host_cliff.argtypes = [I32, P, I32, I32, I32, I32, P]
    so.host_cliff.restype = I32
    so.host_bitonic.argtypes = [P, P, P]
    so.host_bitonic.restype = None
    return so


@pytest.mark.parametrize("with_rec", [False, True], ids=["chain", "chainrec"])
def test_host_chain_walk_matches_plain(host_lib, with_rec):
    """chain's kernel as it runs (cliff's walk over the staged advances,
    with no body or with chainrec's record stores) on _cliff_cases (both
    probe blocks, the walk's edges) and on walks of 20,000 steps from 0 and
    3 (the record index wraps at 8,192): checksum and all 16,384 words of
    the record buffer against chain_plain."""
    import torch

    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    long = np.ones(20480, np.int32)
    for adv, n, start, R in _cliff_cases() + [(long, 20000, 0, 1), (long, 20000, 3, 3)]:
        adv = np.ascontiguousarray(adv, np.int32)
        t = torch.from_numpy(adv)
        staged = hp.cliff_staged_words(t, n, start)
        recs = np.zeros(hp.REC_WORDS, np.int32)
        got = host_lib.host_chain(int(with_rec), adv.ctypes.data, n, staged, start, R,
                                  recs.ctypes.data)
        want, want_recs = hp.chain_plain(t, n, start, R, with_rec)
        assert got == int(want[0]), (n, R, start)
        if with_rec:
            assert (recs == want_recs.numpy()).all(), (n, R, start)


def _image() -> np.ndarray:
    return (np.arange(1 << 14, dtype=np.int64) * 40503).astype(np.int32)


def _run_probe(host_lib, probe: str, code: int, rec: np.ndarray):
    """``host_vcopy`` or ``host_iso`` on ``rec`` from :func:`_image`:
    ``(sum, image)``."""
    rec = np.ascontiguousarray(rec, np.int32)
    img = _image()
    got = getattr(host_lib, f"host_{probe}")(code, rec.ctypes.data, img.ctypes.data)
    return got, img


def _hold_vcopy(host_lib, mode: str, rec: np.ndarray, what) -> None:
    import torch

    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    got, img = _run_probe(host_lib, "vcopy", int(mode == "3d"), rec)
    want, want_img = hp.vcopy_plain(torch.from_numpy(rec), torch.from_numpy(_image()), mode)
    assert got == int(want[0]), what
    assert (img == want_img.numpy()).all(), what


@pytest.mark.parametrize("mode", ["2d", "3d"])
def test_host_vcopy_matches_plain(host_lib, mode):
    """The copy body's record loop over both probe blocks' records and over
    edge records (lane 127, windows across rows, srow and drow 7, sources
    overlapping their destination, nw above 128, every byte phase), those
    also at loop counts around the loop's batches of 32 (a batch's last
    records take their plans from the next batch): checksum and the image
    after the last record."""
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    recs = [hp.vcopy_records(hp.tags_from_block(b)[1]) for b in probe_blocks().values()]
    edges = [count_records(vcopy_edges(mode), n) for n in BATCH_EDGE_COUNTS]
    for i, rec in enumerate(recs + [vcopy_edges(mode)] + edges):
        _hold_vcopy(host_lib, mode, rec, i)


def _hold_iso(host_lib, mode: str, rec: np.ndarray, what):
    import torch

    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    got, img = _run_probe(host_lib, "iso", hp.ISO_MODES.index(mode), rec)
    want, want_img = hp.iso(torch.from_numpy(rec), torch.from_numpy(_image()), mode)
    assert got == int(want[0]), what
    assert (img == want_img.numpy()).all(), what


@pytest.mark.parametrize("mode", ["scalar", "dynload", "dynload8", "statroll", "dynroll", "full"])
def test_host_iso_matches_plain(host_lib, mode):
    """iso's record loops over both probe blocks' records (20 passes, odd
    ones from record 1) and over vcopy's edge records where they stay
    inside the image, at their count and at counts around a batch of 32 (a
    count of 1 leaves the odd passes empty): checksum and the image after
    the last pass."""
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    recs = [hp.iso_records(hp.tags_from_block(b)[1]) for b in probe_blocks().values()]
    edges = [count_records(vcopy_edges("2d"), n) for n in (200, *BATCH_EDGE_COUNTS)]
    for i, rec in enumerate(recs + edges):
        _hold_iso(host_lib, mode, rec, i)


def test_copy_smem_bytes_mirror_the_kernels(host_lib):
    """``hybrid_probes.COPY_SMEM_BYTES``, which chip_smoke.py reports, is
    the copy kernels' shared memory: the image and the plan ring."""
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    assert host_lib.host_copy_smem_bytes() == hp.COPY_SMEM_BYTES


def _coissue_cases(key: int):
    """(seed, tile or None for interpret mode's fill, iters): the TPU's
    8,192 iterations from the fill and from a random tile, and 5 and 37
    (where the tile is not yet 0)."""
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    rand = np.random.default_rng(key).integers(-(1 << 31), 1 << 31, hp.TILE, dtype=np.int64)
    rand = rand.astype(np.int32)
    return ((3, None, 8192), (-5, rand, 8192), (7, rand, 5), (9, rand, 37))


def _host_coissue(host_lib, seed, nvec, tile, iters):
    """host_coissue on a copy of ``tile`` (the fill where None): (sum,
    tile after)."""
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    t = np.full(hp.TILE, hp.FILL, np.int32) if tile is None else tile.copy()
    return host_lib.host_coissue(seed, nvec, iters, t.ctypes.data), t


@pytest.mark.parametrize("nvec", [0, 1, 2, 8])
def test_host_coissue_matches_plain(host_lib, nvec):
    """The scalar chain (its load before its store, the aliasing folded in)
    and the tile updates on a warp of 32 array lanes, 4 words a lane, from
    interpret mode's fill and from a random tile, over the TPU's 8,192
    iterations and over 5 and 37 (where the tile is not yet 0)."""
    import torch

    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    for seed, tile, iters in _coissue_cases(nvec):
        want, want_tile = hp.coissue_plain(seed, nvec, None if tile is None
                                           else torch.from_numpy(tile), iters)
        got, t = _host_coissue(host_lib, seed, nvec, tile, iters)
        assert got == int(want[0]), (seed, nvec, iters)
        assert (t == want_tile.numpy()).all()
        assert (iters == 8192 and nvec > 0) == (not t.any())


def test_host_coissue_vec_matches_plain(host_lib):
    """The vector stream alone (the kernel's nvec -1: the rows at 8 updates,
    no chain) at 5, 37 and 8,192 iterations from the fill and a random tile:
    its tile is coissue_plain's at nvec 8 (the tile never depends on the
    chain) and its sum the tile's count of odd words."""
    import torch

    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    for seed, tile, iters in _coissue_cases(16):
        given = None if tile is None else torch.from_numpy(tile)
        want, want_tile = hp.coissue_vec_plain(given, iters)
        assert (want_tile == hp.coissue_plain(seed, hp.COISSUE_VEC_NVEC, given, iters)[1]).all()
        got, t = _host_coissue(host_lib, seed, hp.COISSUE_VEC, tile, iters)
        assert got == int(want[0]) == int((want_tile & 1).sum()), iters
        assert (t == want_tile.numpy()).all()


@pytest.mark.parametrize("nwhen", [0, 1, 2, 3, 4, 8])
def test_host_bprobe_matches_plain(host_lib, nwhen):
    """bprobe's 524,288 iterations as the kernel runs them, 8,192 blocks of
    64 over the scratch held in an array, at each built nwhen and at seeds 3
    and -5: checksum and scratch against the plain version's iteration at a
    time."""
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    for seed in (3, -5):
        scratch = np.zeros(hp.SCRATCH_WORDS, np.int32)
        got = host_lib.host_bprobe(nwhen, seed, scratch.ctypes.data)
        want, want_scratch = hp.bprobe_plain(nwhen, seed)
        assert got == int(want[0]), seed
        assert (scratch == want_scratch.numpy()).all(), seed


@pytest.mark.parametrize("seed", [3, -5, -(1 << 31)])
def test_host_bprobe_floor_matches_plain(host_lib, seed):
    """The floor yardstick (bprobe's mix alone, x_t = mix(x_{t-1} ^ t)) in
    the kernel's blocks of 64 against its plain version, from the tool's
    seed, a negative one and the fill word."""
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    assert host_lib.host_bprobe_floor(seed) == int(hp.bprobe_floor_plain(seed)[0])


def _cliff_cases():
    """(adv, n, start, R) of the cliff and chase walks: both probe blocks at
    R = 1, 4 and 5 from starts 3, 3 and 0; a walk that ends exactly at n;
    one whose last advance jumps past the advance array's end (the staged
    copy's pad); a start at and past n."""
    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    cases = []
    for b in probe_blocks().values():
        adv, n, _ = hp.chain_inputs(b)
        cases += [(adv, n, start, R) for R, start in ((1, 3), (4, 3), (5, 0))]
    ones = np.ones(64, np.int32)
    jump = ones.copy()
    jump[60] = 40  # from 3: ..., 60, then 100, past the 64 words
    cases += [(ones, 64, 3, 3), (ones, 57, 0, 2), (jump, 64, 3, 3), (jump, 64, 64, 2),
              (jump, 62, 61, 3)]
    return cases


@pytest.mark.parametrize("mode", ["when1", "when2", "fori", "store4", "load4", "chase"])
def test_host_cliff_matches_plain(host_lib, mode):
    """cliff's walk and bodies as the kernel runs them (the advances staged
    as byte offsets, 0 at and past n, padded past n by the largest advance;
    the next load before the body; predicated stores; the exit every 4
    steps) and the chase
    (the walk with no body, chain's function) on _cliff_cases: checksum and
    image against cliff_plain, the chase's sum against chain_plain."""
    import torch

    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    code = 5 if mode == "chase" else hp.CLIFF_MODES.index(mode)
    for adv, n, start, R in _cliff_cases():
        adv = np.ascontiguousarray(adv, np.int32)
        t = torch.from_numpy(adv)
        staged = hp.cliff_staged_words(t, n, start)
        img = np.zeros(hp.IMAGE_WORDS, np.int32)
        got = host_lib.host_cliff(code, adv.ctypes.data, n, staged, start, R, img.ctypes.data)
        if mode == "chase":
            assert got == int(hp.chain_plain(t, n, start, R)[0][0]), (n, R, start)
            continue
        want, want_img = hp.cliff_plain(t, n, mode, start, R)
        assert got == int(want[0]), (n, R, start)
        assert (img == want_img.numpy()).all(), (n, R, start)


@pytest.mark.parametrize("seed", [5, 9])
def test_host_bitonic_matches_plain(host_lib, seed):
    """The sort's stages in the cluster kernel's order (the top three in
    registers on each CTA's runs, the transpose, three rounds of three in
    registers on each tile, j = 8 by the warp's exchange, j = 4, 2, 1)
    against the plain version's whole-array stages: random keys (seed 5 is
    the tool's) and keys with many ties."""
    import torch

    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    rng = np.random.default_rng(seed)
    x = (rng.integers(-(2**31), 2**31 - 1, hp.SORT_N, np.int64) if seed == 5
         else rng.integers(-4, 4, hp.SORT_N)).astype(np.int32)
    keys = np.zeros(hp.SORT_N, np.int32)
    vals = np.zeros(hp.SORT_N, np.int32)
    host_lib.host_bitonic(x.ctypes.data, keys.ctypes.data, vals.ctypes.data)
    want_keys, want_vals = hp.bitonic_plain(torch.from_numpy(x))
    assert (keys == want_keys.reshape(-1).numpy()).all()
    assert (vals == want_vals.reshape(-1).numpy()).all()

