"""Seconds from the start of the process to the first timed call: imports,
the CUDA context, binding (or, in a fresh checkout, building) the kernels,
making the data and warming up every shape the window uses."""


def read(rec):
    return rec.setup_s
