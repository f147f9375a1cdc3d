"""True multi-process distributed execution (jax.distributed + gloo).

This upgrades the multi-host claim beyond virtual devices: two OS processes
(4 virtual CPU devices each) are wired with `jax.distributed.initialize`
and run one data-parallel fit over the global mesh — the same GSPMD program
a multi-host cluster runs, with gloo collectives standing in for the
interconnect.  The result
must match a single-process fit with the same global batch.
"""

import sys

import numpy as np
import pytest


@pytest.mark.timeout(420)
def test_two_process_fit_matches_single():
    sys.path.insert(0, "tools")
    from multiprocess_demo import main

    # distinct port from the demo default to avoid collisions with manual runs
    diff = main(nproc=2, port=52781)
    assert diff < 2e-3
