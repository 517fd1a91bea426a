"""The liveness probe (``snappier_tpu_torch/ops/cuda/watch.py``) on the CPU:
its plain version against the identity kernel of ``tools/tpu_watch.sh``
(run as a Pallas kernel in interpret mode), the wrapper's checks, and the
fresh-build plumbing as far as it goes without ``nvcc``. The kernel itself
runs in ``tests/test_torch_cuda.py`` on a card."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from snappier_tpu_torch.ops.cuda import _build, watch


@pytest.mark.parametrize("salt", [0, 7, 99999, -3])
def test_plain_version_matches_the_pallas_identity_kernel(salt):
    def k(x_ref, o_ref):  # tools/tpu_watch.sh:19-20
        o_ref[...] = x_ref[...] + salt

    x = jnp.arange(1024, dtype=jnp.int32).reshape(8, 128)
    ref = pl.pallas_call(k, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), interpret=True)(x)
    _build.reset_launches()
    got = watch.device_alive(salt, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == watch.SHAPE
    assert (got.numpy() == np.asarray(ref)).all()
    assert int(got[0, 0]) == salt
    assert sum(_build.LAUNCHES.values()) == 0  # CPU: the plain version only


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.arange(8, dtype=torch.int32)
    assert watch.add_salt(x[::2], 5).tolist() == [5, 7, 9, 11]  # made contiguous
    with pytest.raises(ValueError):
        watch.add_salt(x.long(), 1)
    with pytest.raises(ValueError):
        watch.add_salt(x, 1 << 31)
    with pytest.raises(ValueError):
        watch.add_salt(x.numpy(), 1)


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        watch.device_alive()
    assert 0 <= watch.fresh_salt() < 100000


def test_salted_build_names_its_salt_and_leaves_nothing_behind(monkeypatch, tmp_path):
    """Without nvcc the build fails; a stand-in compiler shows the command
    carries the salt, bypasses the hash cache and that the library is
    removed even when binding fails."""
    seen = []

    class Done:
        returncode = 0

        def communicate(self):
            return b"", None

    def fake_popen(cmd, **kw):
        seen.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").write(b"not a library")
        return Done()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", fake_popen)
    for _ in range(2):
        with pytest.raises(OSError):  # ctypes cannot load the stand-in file
            with watch.salted_launcher(1234):
                pass
    assert [c.count("-DWATCH_SALT=1234") for c in seen] == [1, 1]
    outs = [c[c.index("-o") + 1] for c in seen]
    assert outs[0] != outs[1] and all("libwatch-1234-" in o for o in outs)
    assert seen[0][-1].endswith("csrc/watch.cu") and "arch=compute_90a,code=sm_90a" in seen[0]
    assert list(tmp_path.iterdir()) == []
