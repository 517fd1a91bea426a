"""The decode walk's share of its byte roofline over the decompress
phases: compressed bytes in and decoded bytes out over 3.35 TB/s, divided
by the phases' device-busy time."""

from portbench import roofline


def read(rec):
    return roofline.phases_share(rec, "decompress")
