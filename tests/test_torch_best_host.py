"""The candidate-search kernel's schedule (``bc::run_row`` in
``snappier_tpu_torch/csrc/best_candidates.cuh``), compiled for the host with
g++ and held, bit for bit, against its plain version
(``ops/best_match.py::exact_candidates_plain``, which
tests/test_torch_best.py holds against the JAX package).

The host runner runs each phase of the schedule on every thread of every CTA
of a row's cluster before the next phase, each CTA's shared memory a plain
array and a warp 32 array lanes in lock step (``match_any`` and the
exclusive scan over the arrays): the order the kernel's barriers give. The
port never uses this host build.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np
import pytest
import torch

from snappier_tpu_torch.ops.best_match import (
    DEFAULT_WIDTHS,
    MAX_WIDTH,
    exact_candidates_plain,
    widths_mask,
)
from tests.torch_cases import best_rows, gxx_library, invalid_collision_row, long_walk_rows

SHIM = r"""
#include <cstring>
#include <vector>

#include "best_candidates.cuh"

namespace {

struct HostWarp {
  template <class T>
  struct Lanes {
    T v[32];
    T& operator[](int l) { return v[l]; }
    const T& operator[](int l) const { return v[l]; }
  };
  // Highest lane first, as tests/torch_cases.py's ArrayWarp: a lane body
  // that read another lane's result of the same step would differ.
  template <class F>
  void each(F f) const {
    for (int l = 31; l >= 0; l--) f(l);
  }
  Lanes<uint32_t> match_any(const Lanes<uint32_t>& d, int bits) const {
    Lanes<uint32_t> r;
    for (int l = 0; l < 32; l++) {
      r.v[l] = 0;
      for (int o = 0; o < 32; o++) {
        r.v[l] |= (d.v[o] ^ d.v[l]) & ((1u << bits) - 1) ? 0u : 1u << o;
      }
    }
    return r;
  }
  Lanes<uint32_t> excl_scan(const Lanes<uint32_t>& x) const {
    Lanes<uint32_t> r;
    uint32_t s = 0;
    for (int l = 0; l < 32; l++) {
      r.v[l] = s;
      s += x.v[l];
    }
    return r;
  }
  template <class T>
  Lanes<T> up(const Lanes<T>& x) const {
    Lanes<T> r;
    for (int l = 0; l < 32; l++) r.v[l] = x.v[l > 0 ? l - 1 : 0];
    return r;
  }
  template <class T>
  T at(const Lanes<T>& x, int lane) const {
    return x.v[lane];
  }
  Lanes<uint32_t> excl_max(const Lanes<uint32_t>& x) const {
    Lanes<uint32_t> r;
    uint32_t s = 0;
    for (int l = 0; l < 32; l++) {
      r.v[l] = s;
      s = x.v[l] > s ? x.v[l] : s;
    }
    return r;
  }
  void sync() const {}
};

// A row's cluster on the host: every CTA's shared memory, every thread's
// registers; a phase runs on every thread (warp) of every CTA in turn.
struct HostRunner {
  int32_t n;
  std::vector<unsigned char> smem;
  std::vector<bc::ThreadState> st;
  explicit HostRunner(int32_t ctas)
      : n(ctas), smem((size_t)ctas * bc::kSmem, 0xA5), st((size_t)ctas * bc::kThreads) {}
  bc::Cta cta(int32_t c) { return bc::cta_at(&smem[(size_t)c * bc::kSmem]); }
  template <class T>
  T* map(T* p, int32_t rank) {
    const size_t off = (size_t)((unsigned char*)p - smem.data()) % bc::kSmem;
    return (T*)(smem.data() + (size_t)rank * bc::kSmem + off);
  }
  template <class T>
  T get(const T* p, int32_t rank, int32_t j) {
    return map(const_cast<T*>(p), rank)[j];
  }
  void put(int32_t* p, int32_t rank, int32_t j, int32_t v) { map(p, rank)[j] = v; }
  template <class F>
  void threads(F f) {
    for (int32_t c = 0; c < n; c++)
      for (int32_t t = 0; t < bc::kThreads; t++) f(c, t, st[(size_t)c * bc::kThreads + t]);
  }
  template <class F>
  void warps(F f) {
    const HostWarp w;
    for (int32_t c = 0; c < n; c++)
      for (int32_t wi = 0; wi < bc::kWarps; wi++)
        f(c, wi, w, [&](int l) -> bc::ThreadState& {
          return st[(size_t)c * bc::kThreads + wi * 32 + l];
        });
  }
  template <class F>
  void warp0(F f) {
    const HostWarp w;
    for (int32_t c = 0; c < n; c++) f(c, w);
  }
  void cta_sync() {}
  void cluster_sync() {}
  void cluster_arrive() {}
  void cluster_wait() {}
};

}  // namespace

// The kernel's work for B rows of F bytes, a row at a time.
extern "C" void host_best_candidates(const uint8_t* frags, int64_t F, const int32_t* lengths,
                                     int64_t B, uint32_t mask, int32_t* out,
                                     int32_t* fallbacks) {
  const int32_t n = bc::cta_count((int32_t)F);
  for (int64_t b = 0; b < B; b++) {
    const int32_t len = lengths[b] < 0 ? 0 : lengths[b];
    const bc::Row row{frags + b * F, (int32_t)F, len, bc::row_mask(mask, len), n, out + b * F,
                      fallbacks};
    HostRunner r(n);
    bc::run_row(r, row);
  }
}

extern "C" int64_t host_smem_bytes() { return bc::kSmem; }
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    so = gxx_library(SHIM, tmp_path_factory.mktemp("best_host"))
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    so.host_best_candidates.argtypes = [P, I64, P, I64, ctypes.c_uint32, P, P]
    so.host_best_candidates.restype = None
    so.host_smem_bytes.argtypes = []
    so.host_smem_bytes.restype = I64
    return so


def _host(lib, frags: np.ndarray, lens: np.ndarray, widths, fallbacks=None) -> np.ndarray:
    """The host build's candidates; ``fallbacks``, an int32 [1] array, counts
    the widths that rows sorted whole."""
    frags = np.ascontiguousarray(frags, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    B, F = frags.shape
    out = np.full((B, F), 0x5A5A5A5A, np.int32)
    lib.host_best_candidates(frags.ctypes.data, F, lens.ctypes.data, B, widths_mask(widths),
                             out.ctypes.data, None if fallbacks is None else fallbacks.ctypes.data)
    return out


def _plain(frags: np.ndarray, lens: np.ndarray, widths) -> np.ndarray:
    return exact_candidates_plain(torch.from_numpy(np.ascontiguousarray(frags, np.uint8)),
                                  torch.from_numpy(np.asarray(lens, np.int32)), widths).numpy()


def test_host_layout_fits_a_cta(host_lib):
    """Shared memory of a CTA within Hopper's 227 KB a block (less the 1 KB
    the card reserves)."""
    assert host_lib.host_smem_bytes() == 225296 <= 232448 - 1024


@pytest.mark.parametrize("F", [4096, 8193, 20000])
@pytest.mark.parametrize("widths", [DEFAULT_WIDTHS, (4,), (4, 8, 16, 32, 64, 128, 256)],
                         ids=["default", "w4", "to256"])
def test_host_schedule_matches_plain(host_lib, F, widths):
    """Every kind of torch_cases.best_rows (markup, periods 1-7, random,
    zeros) at lengths F, F - 7, 3000, 17, 1 and 0, on one CTA (4,096), two
    (8,193: the second holds one position) and three (20,000)."""
    frags, lens = best_rows(F, lens=(F, F - 7, 3000, 17, 1, 0))
    fallbacks = np.zeros(1, np.int32)
    got = _host(host_lib, frags, lens, widths, fallbacks)
    assert (got == _plain(frags, lens, widths)).all()
    assert fallbacks[0] == 0  # no walk of these rows runs long


def test_host_schedule_full_row_and_wide_widths(host_lib):
    """Rows of 65,536 on all 8 CTAs: markup, period 3, random and zeros (every
    width-4 key alike, and no two alike), with widths up to 32,768, whose
    folds read fingerprints four CTAs away."""
    F = MAX_WIDTH
    frags, lens = best_rows(F, seed=9, lens=(F, F - 5))
    keep = np.r_[0, 1, 6, 7, 16, 17, 18, 19]  # markup, period 3, random, zeros
    frags, lens = frags[keep], lens[keep]
    for widths in (DEFAULT_WIDTHS, (4, 1024, 8192, 32768)):
        got = _host(host_lib, frags, lens, widths)
        assert (got == _plain(frags, lens, widths)).all(), widths


@pytest.mark.parametrize("F", [1, 3, 4, 17])
def test_host_schedule_tiny_rows(host_lib, F):
    """Rows of 1 to 17 bytes at every length up to F, and at lengths past F,
    where the plain version's folds wrap around the row (its roll) and
    widths wider than the row take every position."""
    rng = np.random.default_rng(F)
    frags = np.stack([rng.integers(0, 256, F), np.zeros(F, np.int64)]).astype(np.uint8)
    for n in [*range(F + 1), 3000, -5]:
        lens = np.array([n, n], np.int32)
        for widths in (DEFAULT_WIDTHS, (4, 8, 16, 32, 64, 128, 256)):
            got = _host(host_lib, frags, lens, widths)
            assert (got == _plain(frags, lens, widths)).all(), (n, widths)


def test_host_schedule_pairs_a_left_out_position(host_lib):
    """A width-8 key equal to a left-out position's ``(0x7F000000 + p, p)``:
    the plain version gives p the candidate, and so does the kernel (its
    keys at widths of 8 and more are the plain version's, left-out ones
    included). A width-4 key whose hi is a left-out position q's: no pair
    (width 4's shorter key marks q left out)."""
    row, n, at, p, q = invalid_collision_row()
    frags, lens = row[None], np.array([n], np.int32)
    for widths in (DEFAULT_WIDTHS, (4,)):
        want = _plain(frags, lens, widths)
        assert want[0, p] == (at if 8 in widths else -1) and want[0, q] == -1
        assert (_host(host_lib, frags, lens, widths) == want).all(), widths


def test_width4_keys_never_pair_valid_with_left_out():
    """The premise of width 4's shorter key: a valid width-4 pair is
    (k, k * M2) and a left-out position p's is (0x7F000000 + p, p); for no p
    below 65,536 are they equal, so (hi, left out) groups the positions as
    (hi, lo) does."""
    p = np.arange(MAX_WIDTH, dtype=np.uint64)
    k = np.uint64(0x7F000000) + p
    lo = (k * np.uint64(0xC2B2AE35)) & np.uint64(0xFFFFFFFF)
    assert not (lo == p).any()


def test_host_schedule_long_walks_sort_whole(host_lib):
    """Rows whose walks over one bucket cross more runs than the bound
    (torch_cases.long_walk_rows): 48 width-8 keys of one hi, and 48 width-4
    keys of one bucket, the first of each repeated. Each row sorts that width
    by its whole key, counted once, and the candidates stay the plain
    version's, the repeated key's match included."""
    frags, lens = long_walk_rows()
    fallbacks = np.zeros(1, np.int32)
    got = _host(host_lib, frags, lens, DEFAULT_WIDTHS, fallbacks)
    want = _plain(frags, lens, DEFAULT_WIDTHS)
    assert (got == want).all()
    assert fallbacks[0] == 2
    assert want[0, 24 * 48 + 3] == 3 and want[1, 8 * 48 + 1] == 1  # the repeats find the first
