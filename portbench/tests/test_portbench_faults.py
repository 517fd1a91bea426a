"""The check has to call a broken run not correct: the harness driven with
the timed path broken underneath (each fault a cell can have), and with
the control in the program's place. One cell at a tiny size on the CPU;
the look for a card is skipped by calling the harness in the process."""

from __future__ import annotations

import functools

import pytest
import torch

from portbench_tiny import run_tiny, tiny_root

from portbench import run


def _block_driver(root):
    return run.load_module(root / "drivers" / "block_codec.py")


def _broken_block(drv, fault: str, side: str):
    class Broken(drv.Program):
        def compress(self, frags, lengths):
            packed, body_lens = super().compress(frags, lengths)
            if side != "compress":
                return packed, body_lens
            b = packed.clone().view(torch.uint8)
            if fault == "unchanged":  # the input handed back as its own output
                b.zero_()
                b[:, : frags.shape[1]] = frags
                return b.view(torch.int32), lengths.to(torch.int32)
            if fault == "half":  # the second half of the batch left out
                h = len(body_lens) // 2
                b[h:] = 0
                return b.view(torch.int32), torch.cat([body_lens[:h], body_lens[h:] * 0])
            b[0, int(body_lens[0]) // 2] ^= 0x20  # one byte altered where it is made
            return b.view(torch.int32), body_lens

        def decompress(self, comp, comp_lens):
            outs, out_lens, errs = super().decompress(comp, comp_lens)
            if side != "decompress":
                return outs, out_lens, errs
            o = outs.clone().view(torch.uint8)
            if fault == "unchanged":
                o[:] = comp[:, : o.shape[1]]
            elif fault == "half":
                h = len(out_lens) // 2
                o[h:] = 0
            else:
                o[0, 7] ^= 0x20
            return o.view(torch.int32), out_lens, errs

    return Broken


FAULTS = ["unchanged", "half", "altered"]


@pytest.mark.parametrize("side", ["compress", "decompress"])
@pytest.mark.parametrize("fault", FAULTS)
def test_block_fault_is_not_correct(tmp_path, fault, side):
    root = tiny_root(tmp_path)
    r = run_tiny(root, "block-corpus", program=_broken_block(_block_driver(root), fault, side))
    assert r["correct"] is False and r["failed"] > 0
    name = "bad_compressed_rows" if side == "compress" else "bad_decoded_rows"
    assert r["checks"][name]["value"] > r["checks"][name]["limit"]


def _broken_facade(drv, fault: str):
    class Broken(drv.Program):
        def compress(self, obj):
            out = super().compress(obj)
            if fault == "unchanged":
                return obj
            if fault == "half":  # the second half of the object left out
                half = super().compress(obj[: len(obj) // 2])
                pre = drv.snappy_plain.varint
                return pre(len(obj)) + half[len(pre(len(obj) // 2)):]
            b = bytearray(out)
            b[len(b) // 2] ^= 0x20
            return bytes(b)

    return Broken


@pytest.mark.parametrize("fault", FAULTS)
def test_facade_fault_is_not_correct(tmp_path, fault):
    root = tiny_root(tmp_path)
    drv = run.load_module(root / "drivers" / "facade.py")
    r = run_tiny(root, "facade-best-corpus", program=_broken_facade(drv, fault))
    assert r["correct"] is False and r["checks"]["bad_streams"]["value"] > 0


@pytest.mark.parametrize("workload,entry", [("block-corpus", "block_codec"),
                                            ("facade-best-corpus", "facade")])
def test_control_is_not_correct_and_exact_keys_are(tmp_path, workload, entry):
    """The control (a match taken on a 16-bit hash, bytes not compared) in
    the program's place fails the check; the same encoder comparing bytes
    passes it, so the check judges what the streams say and not whose they
    are."""
    root = tiny_root(tmp_path)
    drv = run.load_module(root / "drivers" / f"{entry}.py")
    bad = run_tiny(root, workload, program=functools.partial(drv.Control, key_bits=16))
    assert bad["correct"] is False
    good = run_tiny(root, workload, program=functools.partial(drv.Control, key_bits=None))
    assert good["correct"] is True
