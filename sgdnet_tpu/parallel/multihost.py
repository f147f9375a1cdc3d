"""Multi-host execution helpers.

On a multi-host cluster, each host runs the same program under
`jax.distributed`; `init_multihost()` wires the processes together and
`global_data_mesh()` builds the 1-D 'data' mesh over ALL devices of all
hosts.  The data-parallel SAGA layer (parallel/dist.py) is
topology-agnostic: rows and gradient memory shard over the global mesh and
the per-step psum spans every device, whichever link joins them.

Exercised two ways without a cluster: virtual-device sharding tests
(tests/test_parallel.py) and a TRUE multi-process run — two OS processes,
4 virtual CPU devices each, wired by `jax.distributed` with gloo collectives
standing in for the interconnect (tests/test_multihost.py,
tools/multiprocess_demo.py) —
which runs this exact module end-to-end and matches the single-process fit.
"""

from __future__ import annotations

import jax

from sgdnet_tpu.parallel.dist import AXIS, make_mesh


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None, process_id: int | None = None):
    """Initialize jax.distributed (no-op if already initialized).  Without
    a cluster manager, pass all three arguments."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        # already initialized
        pass
    return jax.process_index(), jax.process_count()


def global_data_mesh():
    """1-D 'data' mesh over every device in the (multi-host) system."""
    return make_mesh(devices=jax.devices(), axis=AXIS)
