"""Seconds from the process start to the window's start: imports, input
generation and indexing, the engine and kernel library, the workers'
start and the warm-up job."""


def read(run):
    return run.setup_s
