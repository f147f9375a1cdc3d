"""Scaling-efficiency harness: nnz/s at 1, 2, ..., N devices.

The BASELINE.md target is >= 80% nnz/s efficiency from 1 host to N hosts on
a sparse binomial workload.  This harness runs the same sharded SAGA
workload over growing sub-meshes and reports throughput and efficiency.

On real multi-device hardware the psum crosses the interconnect and the
numbers are meaningful; under `--xla_force_host_platform_device_count` virtual devices
(the only option in a single-chip environment) the harness validates the
mechanism and the collective layout, not real interconnect scaling —
flagged in the output.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from sgdnet_tpu.families import get_family
from sgdnet_tpu.penalties import select_penalty
from sgdnet_tpu.parallel.dist import fit_path_sharded, make_mesh, pad_to_shards, shard_inputs
from sgdnet_tpu.solver.saga import SolverConfig, init_state


def measure_scaling(
    n=20_000,
    p=512,
    density=0.1,
    batch_per_device=256,
    epochs=3,
    device_counts=None,
    seed=0,
):
    """Returns {n_devices: nnz_per_s} plus an 'efficiency' entry."""
    if device_counts is None:
        n_dev = len(jax.devices())
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]

    rng = np.random.default_rng(seed)
    x_np = (rng.random((n, p)) < density) * rng.normal(size=(n, p))
    lp = x_np[:, 0] - x_np[:, 1]
    y_np = (rng.random(n) < 1 / (1 + np.exp(-lp))).astype(np.float32).reshape(-1, 1)
    nnz = int(np.count_nonzero(x_np))

    family = get_family("binomial")
    penalty = select_penalty(1.0, "binomial")

    results = {}
    for nd in device_counts:
        mesh = make_mesh(nd)
        n_pad = pad_to_shards(n, nd, batch_per_device)
        x = jnp.zeros((n_pad, p), jnp.float32).at[:n].set(jnp.asarray(x_np, jnp.float32))
        y = jnp.zeros((n_pad, 1), jnp.float32).at[:n].set(jnp.asarray(y_np))
        w = jnp.zeros((n_pad,), jnp.float32).at[:n].set(1.0)
        x, y, w = shard_inputs(mesh, x, y, w)
        config = SolverConfig(
            batch_size=batch_per_device, max_iter=epochs, fit_intercept=True,
            axis_name="data",
            # fixed-epoch throughput measurement: tol=0 always exits code-1,
            # which must NOT trigger the solver's in-program retry (it would
            # triple the measured work)
            step_backoff=False,
        )
        state0 = init_state(n_pad, p, 1, jnp.float32)
        from jax.sharding import NamedSharding, PartitionSpec as P

        state0 = state0._replace(
            g_mem=jax.device_put(state0.g_mem, NamedSharding(mesh, P("data", None)))
        )
        args = (
            jnp.ones((1,), jnp.float32) * 1e-3,  # gammas
            jnp.ones((1,), jnp.float32) * 1e-4,  # l1
            jnp.zeros((1,), jnp.float32),  # l2
            jnp.float32(0.0),  # tol=0 -> run exactly max_iter epochs
            jax.random.PRNGKey(seed),
            state0,
            family,
            penalty,
            config,
        )
        jax.block_until_ready(fit_path_sharded(x, y, w, None, *args, mesh=mesh))
        best = float("inf")
        for r in range(1, 4):
            a = args[:4] + (jax.random.PRNGKey(seed + r),) + args[5:]
            t0 = time.perf_counter()
            jax.block_until_ready(fit_path_sharded(x, y, w, None, *a, mesh=mesh))
            best = min(best, time.perf_counter() - t0)
        results[nd] = nnz * epochs / best

    base = results[device_counts[0]] / device_counts[0]
    results["efficiency"] = {
        nd: results[nd] / (nd * base) for nd in device_counts
    }
    results["virtual_devices"] = jax.default_backend() == "cpu"
    return results


if __name__ == "__main__":
    import json

    r = measure_scaling()
    print(json.dumps({str(k): v for k, v in r.items()}, default=str, indent=2))
