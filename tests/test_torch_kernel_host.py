"""The CUDA kernels' per-block walks (``snappier_tpu_torch/csrc/scalar_codec.cuh``),
compiled for the host with g++ and held against the JAX scalar kernels in
Pallas interpret mode.

The walks are ``__host__ __device__`` functions, so this is the one place
their own logic runs without a GPU. The decode walk runs both on one lane
and split over 4 threads that meet at a barrier after every tag, as the
lanes of a warp do at ``__syncwarp``. The port never uses this host build.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from snappier_tpu.format import oracle
from snappier_tpu.format.varint import write_varint
from snappier_tpu.ops.pallas.scalar_codec import (
    decode_blocks_scalar,
    encode_blocks_scalar,
)
from tests.torch_cases import corrupt_streams, encode_rows, pack_streams

CSRC = pathlib.Path(__file__).resolve().parents[1] / "snappier_tpu_torch" / "csrc"

SHIM = r"""
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#include "scalar_codec.cuh"

namespace {
struct NoSync {
  void operator()() const {}
};

// Reusable barrier for the lanes of one block (a host stand-in for
// __syncwarp).
struct Barrier {
  std::mutex mu;
  std::condition_variable cv;
  int count, waiting = 0, phase = 0;
  explicit Barrier(int n) : count(n) {}
  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    int ph = phase;
    if (++waiting == count) {
      waiting = 0;
      phase++;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return phase != ph; });
    }
  }
};

struct BarrierSync {
  Barrier* b;
  void operator()() const { b->wait(); }
};
}  // namespace

extern "C" void host_decode(const uint8_t* comp, int64_t cc, const int32_t* lens,
                            int64_t batch, int32_t out_cap, int32_t nlanes, uint8_t* out,
                            int32_t* out_lens, int32_t* errs) {
  for (int64_t b = 0; b < batch; b++) {
    const uint8_t* row = comp + b * cc;
    uint8_t* dst = out + b * out_cap;
    if (nlanes == 1) {
      sc::DecodeResult r = sc::decode_block(row, cc, lens[b], out_cap, dst, 0, 1, NoSync());
      out_lens[b] = r.out_len;
      errs[b] = r.err;
      continue;
    }
    Barrier bar(nlanes);
    std::vector<sc::DecodeResult> res(nlanes);
    std::vector<std::thread> lanes;
    for (int lane = 0; lane < nlanes; lane++) {
      lanes.emplace_back([&, lane] {
        res[lane] = sc::decode_block(row, cc, lens[b], out_cap, dst, lane, nlanes,
                                     BarrierSync{&bar});
      });
    }
    for (auto& t : lanes) t.join();
    for (int lane = 1; lane < nlanes; lane++) {
      if (res[lane].out_len != res[0].out_len || res[lane].err != res[0].err) {
        res[0].err = -1;  // lanes disagreed: never a valid error word
      }
    }
    out_lens[b] = res[0].out_len;
    errs[b] = res[0].err;
  }
}

extern "C" void host_encode(const uint8_t* frags, int64_t frag_w, const int32_t* lens,
                            int64_t batch, int32_t hash_bits, int32_t skip_base,
                            uint8_t* bodies, int64_t body_w, int32_t* body_lens) {
  std::vector<uint16_t> table((size_t)1 << hash_bits);
  std::vector<uint8_t> s(frag_w + 8);
  for (int64_t b = 0; b < batch; b++) {
    int32_t n = lens[b] < 0 ? 0 : (lens[b] > frag_w ? (int32_t)frag_w : lens[b]);
    for (auto& e : table) e = sc::EMPTY;
    for (int64_t i = 0; i < frag_w + 8; i++) s[i] = i < n ? frags[b * frag_w + i] : 0;
    body_lens[b] = sc::encode_fragment(s.data(), n, table.data(), hash_bits, skip_base,
                                       bodies + b * body_w);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("walk_host")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libwalk.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread", "-I", str(CSRC),
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    so = ctypes.CDLL(str(lib))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    so.host_decode.argtypes = [P, I64, P, I64, I32, I32, P, P, P]
    so.host_decode.restype = None
    so.host_encode.argtypes = [P, I64, P, I64, I32, I32, P, I64, P]
    so.host_encode.restype = None
    return so


def _host_decode(lib, comp, lens, out_cap, nlanes):
    comp = np.ascontiguousarray(comp, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    B, cc = comp.shape
    out = np.zeros((B, out_cap), np.uint8)
    out_lens = np.zeros(B, np.int32)
    errs = np.zeros(B, np.int32)
    lib.host_decode(comp.ctypes.data, cc, lens.ctypes.data, B, out_cap, nlanes,
                    out.ctypes.data, out_lens.ctypes.data, errs.ctypes.data)
    return out, out_lens, errs


def _host_encode(lib, frags, lens, hash_bits=15, skip_base=32):
    frags = np.ascontiguousarray(frags, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    B, F = frags.shape
    W = F + 2048
    bodies = np.zeros((B, W), np.uint8)
    body_lens = np.zeros(B, np.int32)
    lib.host_encode(frags.ctypes.data, F, lens.ctypes.data, B, hash_bits, skip_base,
                    bodies.ctypes.data, W, body_lens.ctypes.data)
    return bodies, body_lens


@pytest.mark.parametrize("F", [1024, 8192, 65536])
def test_host_encode_walk_matches_jax(host_lib, F):
    frags, lens = encode_rows(F)
    ref_b, ref_l = encode_blocks_scalar(jnp.asarray(frags), jnp.asarray(lens), interpret=True)
    ref_b, ref_l = np.asarray(ref_b), np.asarray(ref_l)
    got_b, got_l = _host_encode(host_lib, frags, lens)
    assert (got_l == ref_l).all(), (got_l, ref_l)
    for i in range(len(lens)):
        assert (got_b[i, : got_l[i]] == ref_b[i, : ref_l[i]]).all(), i
        comp = write_varint(int(lens[i])) + got_b[i, : got_l[i]].tobytes()
        assert oracle.decompress(comp) == frags[i, : lens[i]].astype(np.uint8).tobytes()


@pytest.mark.parametrize("nlanes", [1, 4])
def test_host_decode_walk_matches_jax(host_lib, nlanes):
    streams = [oracle.compress(np.frombuffer(d, np.uint8)) for d in (
        b"", b"a", b"ab" * 50, b"a" * 300, b"the quick brown snappy " * 20, bytes(500),
        bytes(range(1, 6)) * 150,
    )] + corrupt_streams()
    comp, lens = pack_streams(streams, 2048)
    ref = [np.asarray(x) for x in decode_blocks_scalar(
        jnp.asarray(comp), jnp.asarray(lens), out_cap=1024, interpret=True)]
    out, out_lens, errs = _host_decode(host_lib, comp, lens, 1024, nlanes)
    assert (errs == ref[2]).all(), (errs, ref[2])
    assert (out_lens == ref[1]).all()
    for i in range(len(streams)):
        assert (out[i, : out_lens[i]] == ref[0][i, : ref[1][i]]).all(), i
