"""The best-level compress's share of its byte roofline: each call's input
bytes and stream bytes over 3.35 TB/s, divided by the device-busy time
inside the calls (candidate search, the best encode walk and their
glue)."""

from portbench import roofline


def read(rec):
    return roofline.phases_share(rec, "compress")
