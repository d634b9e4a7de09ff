"""Torch's CPU thread count for the port's tests under pytest-xdist.

In an xdist run every worker process runs its own tests at once beside the
others, and torch's default of one thread a core in each of them puts
several times as many busy threads as cores on the machine: the JAX
package's tests, whose XLA compiles run on one thread, then get about a
third of a core (`tests/test_models.py` beside five port test files on 8
cores: 37% of a core over its first 300 s with torch's 8 threads in each,
84% with 2). An xdist worker therefore runs torch's CPU work on
XDIST_THREADS threads. Every worker imports every test module when it
collects, so the limit holds for the whole worker; a run without xdist
keeps torch's default.
"""

import os

import torch

XDIST_THREADS = 2


def limit_under_xdist():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(XDIST_THREADS)
