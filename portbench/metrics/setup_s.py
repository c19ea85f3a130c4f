"""Seconds from the process's start to the window's opening: imports,
CUDA initialisation, the kernels' build or load, inputs and weights made
from the seed, the model loaded, every shape of the cell warmed up."""


def read(run):
    return run["setup_s"]
