"""Uncompressed bytes compressed over the summed wall time of the
window's compress phases (each ends with its results complete)."""

from portbench import roofline


def read(rec):
    return roofline.rate_gbps(rec, "compress", "bytes_in")
