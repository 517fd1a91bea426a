"""The facade's uncompressed bytes compressed over the summed wall time of
the window's calls, each timed until its ``bytes`` are returned."""

from portbench import roofline


def read(rec):
    return roofline.rate_gbps(rec, "compress", "bytes_in")
