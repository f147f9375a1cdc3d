"""Hybrid-layout planner: pick the dense-head width from a measured cost
model.

The dense-head/sparse-tail split (core/sparse.py HybridCSR) has one free
parameter that matters: the head width D.  Its economics:

  * the head streams  (2 + 1/refresh) * n_pad * D * itemsize  bytes per
    epoch through device memory at the sustained rate of the solver's head
    step, independent of how many of those values are real nonzeros;
  * every tail entry costs ~4 gather/scatter element-ops (forward gather +
    scatter, outer gather + scatter) at the packed BlockCOO tail's cost
    per element.

So a column belongs in the head when its total nonzero count exceeds
    break_even = passes * n_pad * itemsize / stream / (4 * elem_op_s)
(~690 nonzeros per column for an int8 head at n = 100k with the constants
below), and the optimal D is where the column-popularity curve crosses
that line.  `plan_layout` computes it exactly from the column counts,
subject to a device-memory budget.

`fit(hybrid_max_head="auto")` calls this; the explicit function is public
for planning without fitting.

Two-level heads (an int8 "hot" level plus a bf16 "warm" one) are dominated
under this model: storage levels are totally ordered by stream cost, and
every column that clears the bf16 break-even clears the int8 one, so
widening the int8 head always beats adding a bf16 level.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: sustained rate of the head stream: two passes over an int8 (8192,
#: 32768) block per solver step (forward matmul + outer product) in 460 us
#: as XLA compiles them — chip_smoke.py `head_step`, NVIDIA H100 80GB HBM3
#: at a 400 W power limit
STREAM_BYTES_PER_S = 1.166e12
#: BlockCOO tail cost per element-op at 262144 entries per block of 8192
#: rows — chip_smoke.py `tail_element_cost`, same card and power limit
ELEM_OP_S = 7.04e-11
#: element-ops per tail entry per step: fwd gather + fwd scatter +
#: outer gather + outer scatter
TAIL_OPS_PER_ENTRY = 4


@dataclass(frozen=True)
class LayoutPlan:
    """Planner output: the head width plus the predicted per-epoch costs."""

    max_head: int  # recommended head width D (multiple of 128)
    head_ms: float  # predicted head stream time per epoch
    tail_ms: float  # predicted tail element-op time per epoch
    coverage: float  # fraction of nonzeros landing in the head
    head_bytes: int  # resident head size at n_pad rows
    break_even_nnz: float  # column-count threshold that set D


def plan_layout(
    x,
    *,
    batch_size: int = 8192,
    head_itemsize: int = 1,
    g_sum_refresh_every: int = 8,
    hbm_budget: float = 24e9,
    stream_bytes_per_s: float = STREAM_BYTES_PER_S,
    elem_op_s: float = ELEM_OP_S,
    max_head_cap: int | None = None,
) -> LayoutPlan:
    """Choose the hybrid head width for a scipy sparse matrix.

    `head_itemsize` is the storage itemsize of the head (1 for int8, 2 for
    bfloat16, 4 for float32 — pass what you will pass as
    `hybrid_head_dtype`).  `hbm_budget` caps the resident head bytes: by
    default 24 GB, under a third of an 80 GB card, because JAX allocates
    three quarters of the card and ingestion holds about two copies of the
    head at once (row shuffle) next to the tail and the solver state.
    """
    x = x.tocsr()
    n, p = x.shape
    n_pad = ((n + batch_size - 1) // batch_size) * batch_size
    col_nnz = np.bincount(x.indices, minlength=p)
    order = np.argsort(-col_nnz, kind="stable")
    sorted_nnz = col_nnz[order].astype(np.int64)
    total = max(int(sorted_nnz.sum()), 1)

    passes = 2.0 + 1.0 / max(g_sum_refresh_every, 1)
    head_cost_per_col = passes * n_pad * head_itemsize / stream_bytes_per_s
    tail_cost_per_entry = TAIL_OPS_PER_ENTRY * elem_op_s
    # a column pays head_cost_per_col dense or c_nnz * tail_cost_per_entry
    # sparse — move it into the head while its count clears the break-even
    break_even = head_cost_per_col / tail_cost_per_entry
    d = int(np.searchsorted(-sorted_nnz, -break_even, side="right"))

    budget_cols = int(hbm_budget // max(n_pad * head_itemsize, 1))
    d = min(d, budget_cols)
    if max_head_cap is not None:
        d = min(d, max_head_cap)
    d = min(max(d, 1), p)
    d = min(((d + 127) // 128) * 128, p)  # lane-align (pad up, then cap)

    cum = np.cumsum(sorted_nnz)
    head_nnz = int(cum[d - 1]) if d >= 1 else 0
    tail_nnz = total - head_nnz
    head_ms = passes * n_pad * d * head_itemsize / stream_bytes_per_s * 1e3
    tail_ms = tail_nnz * tail_cost_per_entry * 1e3
    return LayoutPlan(
        max_head=d,
        head_ms=head_ms,
        tail_ms=tail_ms,
        coverage=head_nnz / total,
        head_bytes=n_pad * d * head_itemsize,
        break_even_nnz=break_even,
    )
