"""Seconds from the process's start to the start of the measured window:
imports, the card's first use, inputs and weights from the seed, the
port's weight folding, the kernel library's load (its nvcc build on a
checkout's first run), add_reference and one warm evaluate."""


def read(run):
    return run.setup_s
