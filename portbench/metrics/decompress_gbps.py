"""Uncompressed bytes produced over the summed wall time of the window's
decompress phases."""

from portbench import roofline


def read(rec):
    return roofline.rate_gbps(rec, "decompress", "bytes_out")
