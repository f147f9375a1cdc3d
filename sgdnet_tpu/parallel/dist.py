"""Data-parallel sharded SAGA over a device mesh.

The reference is strictly single-threaded (SURVEY.md §2c: no threads, no
MPI/NCCL, no device code anywhere in src/).  This module is the designed-new
scale-out layer: the design matrix, response, sample weights, and per-sample
gradient memory are **row-sharded** over a 1-D `Mesh(('data',))`, while the
coefficients `w`, intercept, and gradient average `g_sum` are **replicated**.

Each batched SAGA step is SPMD: every device draws a local minibatch from
its own row shard, computes its local rank-B statistics, and a single
`psum` per step (the (k, p) `corr` matrix plus two scalars/vectors) forms
the global batch update — which every device then applies identically to
its replicated copy of the state.  This is mathematically identical to a
single-device minibatch SAGA with global batch B_local * n_devices drawn
stratified-by-shard, so the fixed point (and the 1e-3 coefficient contract)
is unchanged while throughput scales with the mesh.

Collectives are XLA psums (NCCL all-reduces on GPUs; every card of a host
reaches every other over NVLink, so the mesh stays 1-D); there is no
parameter server and no host round-trip inside the path: the entire lambda path (while-loop epochs
included) runs as one shard_mapped computation per device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from sgdnet_tpu.core.sparse import HybridCSR, PaddedCSR
from sgdnet_tpu.solver.saga import PathResults, SagaState, SolverConfig, fit_path

AXIS = "data"


def make_mesh(n_devices: int | None = None, devices=None, axis: str = AXIS) -> Mesh:
    """1-D mesh over the first n_devices devices ('data' axis by default;
    pass axis='folds' for fold-parallel CV)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def pad_to_shards(n: int, n_shards: int, batch_size: int) -> int:
    """Rows per shard must be a multiple of batch_size; total rows a multiple
    of shards * batch_size."""
    per = n_shards * batch_size
    return ((n + per - 1) // per) * per


def shard_inputs(mesh: Mesh, x, y, weights):
    """Place x/y/weights row-sharded on the mesh."""
    row = NamedSharding(mesh, P(AXIS))
    row2 = NamedSharding(mesh, P(AXIS, None))
    y = jax.device_put(y, row2)
    weights = jax.device_put(weights, row)

    def shard_csr(csr: PaddedCSR) -> PaddedCSR:
        return PaddedCSR(
            jax.device_put(csr.indices, row2),
            jax.device_put(csr.values, row2),
            jax.device_put(csr.nnz, row),
            csr.n_rows,
            csr.n_cols,
        )

    if isinstance(x, HybridCSR):
        rep = NamedSharding(mesh, P(None))
        # packed BlockCOO tail: blocks are contiguous row ranges and
        # pad_to_shards makes rows-per-shard a batch multiple, so sharding
        # the block axis IS the row partition (each shard gets exactly its
        # own blocks, with block-local row indices that need no adjustment)
        blk = x.blk_tail
        if blk is not None:
            from sgdnet_tpu.core.sparse import BlockCOO

            blk = BlockCOO(
                jax.device_put(blk.rows, row2),
                jax.device_put(blk.cols, row2),
                jax.device_put(blk.vals, row2),
                blk.batch,
                blk.n_cols,
            )
        x = HybridCSR(
            jax.device_put(x.head, row2), shard_csr(x.tail), x.n_rows, x.n_cols,
            blk_tail=blk,
            head_scale=None if x.head_scale is None
            else jax.device_put(x.head_scale, rep),
        )
    elif isinstance(x, PaddedCSR):
        x = shard_csr(x)
    else:
        x = jax.device_put(x, row2)
    return x, y, weights


def _specs_for_x(x):
    if isinstance(x, HybridCSR):
        from sgdnet_tpu.core.sparse import BlockCOO

        return HybridCSR(
            P(AXIS, None),
            PaddedCSR(P(AXIS, None), P(AXIS, None), P(AXIS), x.tail.n_rows, x.tail.n_cols),
            x.n_rows,
            x.n_cols,
            # packed tail sharded over its block axis (= the row partition)
            blk_tail=None if x.blk_tail is None else BlockCOO(
                P(AXIS, None), P(AXIS, None), P(AXIS, None),
                x.blk_tail.batch, x.blk_tail.n_cols,
            ),
            # int8 head: per-column dequantization scales are replicated
            head_scale=None if x.head_scale is None else P(None),
        )
    if isinstance(x, PaddedCSR):
        return PaddedCSR(P(AXIS, None), P(AXIS, None), P(AXIS), x.n_rows, x.n_cols)
    return P(AXIS, None)


@partial(jax.jit, static_argnames=("family", "penalty", "config", "mesh"))
def fit_path_sharded(
    x,
    y,
    weights,
    xc,
    gammas,
    l1s,
    l2s,
    tol,
    key,
    state0: SagaState,
    family,
    penalty,
    config: SolverConfig,
    mesh: Mesh,
    offs=None,
    pf=None,
    box=None,
):
    """shard_map-wrapped fit_path: one compiled SPMD program for the whole
    warm-started lambda path.  `offs` is an optional row-sharded (n_pad, k)
    linear-predictor offset; `pf` / `box` are replicated per-feature penalty
    factors / coefficient bounds (see solver.saga.fit_path)."""
    assert config.axis_name == AXIS
    state_specs = SagaState(
        w=P(None, None),
        intercept=P(None),
        g_mem=P(AXIS, None),
        g_sum=P(None, None),
        g_sum_intercept=P(None),
    )
    in_specs = (
        _specs_for_x(x),
        P(AXIS, None),  # y
        P(AXIS),  # weights
        P(None) if xc is not None else None,  # xc replicated
        P(None),
        P(None),
        P(None),  # gammas/l1s/l2s
        P(),  # tol
        P(None),  # key
        state_specs,
        P(AXIS, None) if offs is not None else None,  # offset row-sharded
        P(None) if pf is not None else None,  # penalty factors replicated
        (P(None, None), P(None, None)) if box is not None else None,  # bounds replicated
    )
    out_specs = (
        state_specs,
        P(),  # n_iter
        PathResults(
            w=P(None, None, None),
            intercept=P(None, None),
            deviance=P(None),
            n_epochs=P(None),
            return_codes=P(None),
            losses=P(None, None),
            clamp_gap=P(None),
            final_change=P(None),
        ),
    )

    def local_fit(x_l, y_l, w_l, xc_l, gammas, l1s, l2s, tol, key, state_l, offs_l, pf_l, box_l):
        # shard_map hands back locally-shaped leaves; fix logical row counts
        n_local = y_l.shape[0]
        if isinstance(x_l, HybridCSR):
            tail = PaddedCSR(
                x_l.tail.indices, x_l.tail.values, x_l.tail.nnz, n_local, x_l.tail.n_cols
            )
            x_l = HybridCSR(
                x_l.head, tail, n_local, x_l.n_cols,
                blk_tail=x_l.blk_tail, head_scale=x_l.head_scale,
            )
        elif isinstance(x_l, PaddedCSR):
            x_l = PaddedCSR(x_l.indices, x_l.values, x_l.nnz, n_local, x_l.n_cols)
        return fit_path(
            x_l, y_l, w_l, xc_l, gammas, l1s, l2s, tol, key, state_l, family, penalty, config,
            offs=offs_l, pf=pf_l, box=box_l,
        )

    fn = shard_map(local_fit, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    return fn(x, y, weights, xc, gammas, l1s, l2s, tol, key, state0, offs, pf, box)
