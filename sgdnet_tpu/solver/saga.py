"""Batched SAGA engine.

Accelerator re-design of the reference's sequential SAGA inner loops
(reference src/saga-dense.h:100-224 and src/saga-sparse.h:195-383).

Design notes — why this is not a translation
--------------------------------------------
The reference performs n strictly sequential single-sample updates per
epoch, with two CPU-oriented optimizations: a lazy L2 scale (`wscale`) so
the O(p) decay is deferred, and lag tables with closed-form geometric
catch-up so untouched features skip their prox steps
(reference src/saga-sparse.h:76-155, 229-240).  Both exist because touching
all p features per sample is expensive on a scalar CPU.

On an accelerator the economics invert: a dense (k, p) elementwise decay +
prox costs almost nothing next to the matmuls, while serialized
per-sample updates leave the matrix units idle.  So the engine here does
*minibatch SAGA*: each step takes B samples, computes their linear
predictors and the rank-B coefficient update as two matmuls, and applies
the L2 decay and prox
densely once per step.  No wscale, no lag tables — their closed-form
algebra is exactly what the dense decay computes directly.

Fixed-point equivalence: a batched step is
    w <- prox_{gamma*l1}( w (1 - gamma*l2) - gamma * ((1/B) sum_b (g_b - m_b) x_b + g_sum) )
At a fixed point the memory equals the current per-sample gradients, so
the correction term vanishes in expectation and the fixed-point equation
    w* = prox_{gamma*l1}( w* (1 - gamma*l2) - gamma * grad f(w*) )
is the optimality condition of the elastic-net GLM objective — for every
B, including the reference's B = 1.  Batch size therefore changes the
trajectory (and epochs-to-converge; see stepsize.py) but not the solution,
which is what the reference's own tests assert (coefficients at 1e-3).

Sampling uses per-epoch random permutations (`jax.random`) instead of the
reference's with-replacement draws (reference src/saga-dense.h:152, R's
RNG): no duplicate index ever lands in one batch, which keeps the
`g_mem` scatter and the g_sum invariant exact.

Sparse matrices are handled in padded-CSR form with two strategies:
  * 'densify' — scatter the B rows into a dense (B, p) block, then the
    dense matmul path (best for moderate p);
  * 'gather'  — gather w columns for the forward pass and scatter-add the
    rank-B update (best for very large p).
Standardized sparse data stays scale-only, with centering carried as the
rank-1 `x_center_scaled` correction term, exactly like the reference
(reference src/utils.h:110-121, src/saga-sparse.h:274-277) — the design
matrix is never densified globally.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sgdnet_tpu.core.sparse import HybridCSR, PaddedCSR, int8_matmul, int8_tmatmul
from sgdnet_tpu.families.families import Family
from sgdnet_tpu.penalties.penalties import Penalty


class SagaState(NamedTuple):
    """Warm-started solver state carried across the lambda path
    (reference src/sgdnet.cpp:187-198)."""

    w: jnp.ndarray  # (k, p) coefficients
    intercept: jnp.ndarray  # (k,)
    g_mem: jnp.ndarray  # (n_pad, k) per-sample gradient memory
    g_sum: jnp.ndarray  # (k, p) gradient average
    g_sum_intercept: jnp.ndarray  # (k,)


@dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (hashable; passed to jit as static)."""

    batch_size: int = 32
    max_iter: int = 1000
    fit_intercept: bool = True
    #: lower learning rate for the intercept on sparse data to avoid
    #: oscillation (reference src/saga-sparse.h:300-304 uses 0.01)
    intercept_decay: float = 1.0
    #: recompute g_sum exactly from g_mem at each epoch end (one matmul) —
    #: kills float32 accumulation drift in the gradient average
    g_sum_refresh: bool = True
    #: refresh cadence in epochs (1 = every epoch).  The refresh re-streams
    #: the whole design matrix once, so on HBM-bound workloads a cadence of
    #: 4-8 removes up to a third of the per-epoch memory traffic; drift over
    #: a few epochs is far below the 1e-3 coefficient contract and the exact
    #: recompute still lands before the state is consumed
    g_sum_refresh_every: int = 1
    #: 'densify' or 'gather' (sparse x only; ignored for dense)
    sparse_mode: str = "densify"
    #: record the epoch loss trace (reference debug option, R/zzz.R:17)
    debug: bool = False
    #: mesh axis name for data-parallel execution under shard_map: rows of
    #: x / y / weights / g_mem are sharded over this axis, w / g_sum are
    #: replicated, and batch statistics are psum-reduced (see parallel/dist.py)
    axis_name: str | None = None
    #: unroll factor for the per-epoch scan over batches (amortizes fixed
    #: per-step costs at the price of compile time)
    scan_unroll: int = 1
    #: batch selection: "permutation" (fresh row permutation per epoch,
    #: gathers) or "block" (fixed contiguous blocks in random order —
    #: contiguous reads instead of row gathers; fit() pre-shuffles rows
    #: once so blocks are random samples)
    sampling: str = "permutation"
    #: matmul precision: "highest" = full float32 products (default; a
    #: reduced-precision float32 product — TF32 on the GPU — keeps about
    #: three decimal digits and loses ~1e-2 on large logits), "default" =
    #: the backend's fast mode
    matmul_precision: str = "highest"
    #: optimization barrier between steps (debug/experiment knob: prevents
    #: any cross-step fusion)
    step_barrier: bool = False
    #: in-program oscillation recovery: a lambda that hits max_iter with a
    #: final relative change far above tol (the expected-smoothness step
    #: can oscillate where the active set densifies mid-path —
    #: tests/test_backoff.py) is retried once from the same warm-start
    #: state with the step halved; the retry is kept only if it does better,
    #: and a winning halving sticks for deeper lambdas.  Runs inside the
    #: jitted path program, so the DEFAULT single-dispatch path recovers
    #: without any user-visible knob
    step_backoff: bool = True


def _psum(v, config: SolverConfig):
    if config.axis_name is None:
        return v
    return jax.lax.psum(v, config.axis_name)


def init_state(n_pad: int, n_features: int, n_classes: int, dtype) -> SagaState:
    return SagaState(
        w=jnp.zeros((n_classes, n_features), dtype),
        intercept=jnp.zeros((n_classes,), dtype),
        g_mem=jnp.zeros((n_pad, n_classes), dtype),
        g_sum=jnp.zeros((n_classes, n_features), dtype),
        g_sum_intercept=jnp.zeros((n_classes,), dtype),
    )


# ---------------------------------------------------------------------------
# batched linear algebra on the design matrix
# ---------------------------------------------------------------------------
#
# Batch selection `sel` is either an int32 index vector (a slice of the
# per-epoch permutation — row gather) or a scalar block start (contiguous
# `dynamic_slice`, which reads device memory in order instead of
# gathering rows; see SolverConfig.sampling).


def _rows(a, sel, B: int):
    """Extract B rows of `a` by index vector or contiguous start scalar."""
    if sel.ndim == 0:
        return jax.lax.dynamic_slice_in_dim(a, sel, B, axis=0)
    return a[sel]


def _set_rows(a, sel, vals, B: int):
    """Write B rows of `a` at `sel` (index vector or contiguous start)."""
    if sel.ndim == 0:
        return jax.lax.dynamic_update_slice_in_dim(a, vals, sel, axis=0)
    return a.at[sel].set(vals)


def _csr_batch_predict(csr: PaddedCSR, w, sel, B: int):
    ib = _rows(csr.indices, sel, B)  # (B, L)
    vb = _rows(csr.values, sel, B)  # (B, L)
    wt = w.T  # (p, k)
    return jnp.einsum("bl,blk->bk", vb, wt[ib], preferred_element_type=w.dtype)


def _use_blk_tail(x, sel, B: int) -> bool:
    """Packed-COO tail ops apply when batches are fixed blocks of the packed
    size (block sampling inside the epoch; _dataset_loss uses its own block
    length and falls back to the padded tail)."""
    return (
        isinstance(x, HybridCSR)
        and x.blk_tail is not None
        and sel.ndim == 0
        and x.blk_tail.batch == B
    )


def _coo_batch_predict(bt, w, blk, B: int):
    """Tail forward via packed COO: gather w at E true nonzeros, scatter-add
    into the B batch rows — ~1/3 the element-ops of the padded form."""
    r = jax.lax.dynamic_index_in_dim(bt.rows, blk, 0, keepdims=False)  # (E,)
    c = jax.lax.dynamic_index_in_dim(bt.cols, blk, 0, keepdims=False)
    v = jax.lax.dynamic_index_in_dim(bt.vals, blk, 0, keepdims=False)
    wt = w.T  # (p, k)
    contrib = v[:, None].astype(w.dtype) * wt[c]  # gather (E, k)
    return jnp.zeros((B, w.shape[0]), w.dtype).at[r].add(contrib)


def _coo_batch_outer(bt, g_change, blk):
    """Tail part of the rank-B update via packed COO: (k, p)."""
    r = jax.lax.dynamic_index_in_dim(bt.rows, blk, 0, keepdims=False)
    c = jax.lax.dynamic_index_in_dim(bt.cols, blk, 0, keepdims=False)
    v = jax.lax.dynamic_index_in_dim(bt.vals, blk, 0, keepdims=False)
    k = g_change.shape[1]
    contrib = v[:, None].astype(g_change.dtype) * g_change[r]  # gather (E, k)
    corr_t = jnp.zeros((bt.n_cols, k), g_change.dtype).at[c].add(contrib)
    return corr_t.T


def _batch_predict(x, xc, w, sel, B: int):
    """Linear predictors for the selected rows: (B, k).  Handles the sparse
    centering correction lp -= w @ c (reference src/saga-sparse.h:274-277)."""
    if isinstance(x, HybridCSR):
        d = x.n_head
        hb = _rows(x.head, sel, B)  # (B, D)
        if hb.dtype == jnp.int8:
            # int8 head: per-column scales fold into w (lp_b = q_b . (s*w));
            # the int8 bytes are the only device-memory stream — a quarter
            # of f32 (core/sparse.py int8_matmul)
            lp = int8_matmul(hb, (w[:, :d] * x.head_scale.astype(w.dtype)).T, acc=w.dtype)
        else:
            # bf16 head: multiply in bf16 but accumulate in w's dtype —
            # halves the dominant device-memory stream
            wh = w[:, :d] if w.dtype == hb.dtype else w[:, :d].astype(hb.dtype)
            lp = jnp.dot(hb, wh.T, preferred_element_type=w.dtype)
        if _use_blk_tail(x, sel, B):
            lp = lp + _coo_batch_predict(x.blk_tail, w, sel // B, B)
        else:
            lp = lp + _csr_batch_predict(x.tail, w, sel, B)
    elif isinstance(x, PaddedCSR):
        lp = _csr_batch_predict(x, w, sel, B)
    else:
        xb = _rows(x, sel, B)
        lp = jnp.dot(xb, w.T, preferred_element_type=w.dtype)
    if xc is not None:
        lp = lp - jnp.dot(w, xc.astype(w.dtype))
    return lp


def _csr_batch_outer(csr: PaddedCSR, g_change, sel, B: int):
    """Tail/CSR scatter part of the rank-B update: (k, p)."""
    ib = _rows(csr.indices, sel, B)
    vb = _rows(csr.values, sel, B)
    contrib = vb[:, :, None] * g_change[:, None, :]  # (B, L, k)
    k = g_change.shape[1]
    corr_t = (
        jnp.zeros((csr.n_cols, k), g_change.dtype).at[ib.reshape(-1)].add(contrib.reshape(-1, k))
    )
    return corr_t.T


def _batch_outer(x, xc, g_change, sel, B: int, sparse_mode: str):
    """corr[k, j] = sum_b g_change[b, k] * x_eff[b, j], where x_eff is the
    (centered, scaled) row — the rank-B coefficient update."""
    if isinstance(x, HybridCSR):
        d = x.n_head
        hb = _rows(x.head, sel, B)  # (B, D)
        if hb.dtype == jnp.int8:
            head_corr = int8_tmatmul(g_change, hb, acc=g_change.dtype) * x.head_scale.astype(
                g_change.dtype
            )[None, :]
        else:
            gc = g_change if g_change.dtype == hb.dtype else g_change.astype(hb.dtype)
            head_corr = jnp.dot(gc.T, hb, preferred_element_type=g_change.dtype)
        if _use_blk_tail(x, sel, B):
            corr = _coo_batch_outer(x.blk_tail, g_change, sel // B)
        else:
            corr = _csr_batch_outer(x.tail, g_change, sel, B)
        corr = corr.at[:, :d].add(head_corr)
    elif isinstance(x, PaddedCSR):
        ib = _rows(x.indices, sel, B)
        vb = _rows(x.values, sel, B)
        if sparse_mode == "densify":
            rows = jnp.broadcast_to(jnp.arange(B)[:, None], ib.shape)
            xb = jnp.zeros((B, x.n_cols), vb.dtype).at[rows, ib].add(vb)
            corr = jnp.dot(g_change.T, xb, preferred_element_type=g_change.dtype)
        else:  # gather/scatter
            corr = _csr_batch_outer(x, g_change, sel, B)
    else:
        xb = _rows(x, sel, B)
        corr = jnp.dot(g_change.T, xb, preferred_element_type=g_change.dtype)
    if xc is not None:
        corr = corr - jnp.outer(jnp.sum(g_change, axis=0), xc.astype(corr.dtype))
    return corr


def _dataset_loss(x, y, weights, xc, w, intercept, family: Family, config: SolverConfig, block: int = 1024, offs=None, report: bool = True):
    """Weighted total loss over the dataset, computed in row blocks
    (reference src/utils.h:199-227 EpochLoss / :304-329 Deviance).

    `report=True` uses the family's exact reporting loss (no solver clamps);
    `report=False` uses the solver loss (clamped) — the difference flags an
    active clamp at the solution (poisson)."""
    n_pad = y.shape[0]
    block = min(block, n_pad)
    while n_pad % block != 0:
        block //= 2
        block = max(block, 1)
    n_blocks = n_pad // block
    loss_fn = family.loss_report if report else family.loss

    def body(carry, i):
        start = i * block
        lp = _batch_predict(x, xc, w, start, block) + intercept
        if offs is not None:
            lp = lp + _rows(offs, start, block)
        losses = loss_fn(lp, _rows(y, start, block)) * _rows(weights, start, block)
        return carry + jnp.sum(losses), None

    total, _ = jax.lax.scan(body, jnp.zeros((), w.dtype), jnp.arange(n_blocks))
    return _psum(total, config)


# ---------------------------------------------------------------------------
# one batched SAGA step / epoch
# ---------------------------------------------------------------------------


def _make_step(x, y, weights, xc, w_total, family: Family, penalty: Penalty, config: SolverConfig, offs=None, pf=None, box=None):
    B = config.batch_size

    def step_xla(state: SagaState, carry_scalars, sel):
        gamma, l1, l2 = carry_scalars
        yb = _rows(y, sel, B)
        wb = _rows(weights, sel, B)

        lp = _batch_predict(x, xc, state.w, sel, B) + state.intercept
        if offs is not None:
            lp = lp + _rows(offs, sel, B)
        g = family.gradient(lp, yb) * wb[:, None]  # weighted; pad rows -> 0
        g_change = g - _rows(state.g_mem, sel, B)  # (B, k)
        g_mem = _set_rows(state.g_mem, sel, g, B)

        corr = _batch_outer(x, xc, g_change, sel, B, config.sparse_mode)
        return _finish_step(state, gamma, l1, l2, wb, g_change, g_mem, corr)

    def _finish_step(state, gamma, l1, l2, wb, g_change, g_mem, corr):
        bw = jnp.maximum(_psum(jnp.sum(wb), config), 1e-12)
        sum_gc = _psum(jnp.sum(g_change, axis=0), config)  # (k,)

        # (k, p); under data-parallel execution this psum is the largest
        # collective per step — the rank-B update crosses devices once per
        # batch
        corr = _psum(corr, config)
        grad_est = corr / bw + state.g_sum
        # per-feature penalty factors scale both the L2 decay and the prox
        # threshold (glmnet `penalty.factor` semantics; extension — absent
        # in the reference); pf is (p,), broadcast over classes
        l2_decay = gamma * l2 if pf is None else gamma * l2 * pf
        w_half = state.w * (1.0 - l2_decay) - gamma * grad_est
        w_new = penalty.prox(w_half, gamma * l1 if pf is None else gamma * l1 * pf)
        if box is not None:
            # box constraints (glmnet lower.limits/upper.limits): project onto
            # [lo, hi] after the prox.  Exact composite prox for separable
            # penalties (soft-threshold then clip IS prox of l1 + indicator);
            # for the group prox it is the standard projection heuristic.
            w_new = jnp.clip(w_new, box[0], box[1])
        g_sum = state.g_sum + corr / w_total

        if config.fit_intercept:
            # intercept step with the SAME SAGA estimator structure as the
            # coefficient update: fresh batch-mean gradient change + stale
            # average (reference src/saga-dense.h:170-173 is the B=1 case).
            # The fresh term must be the batch mean (sum_gc / bw), NOT
            # sum_gc / n: with a negligible fresh term the intercept follows
            # an up-to-an-epoch-stale averaged gradient, and that delayed
            # feedback loop goes unstable once gamma * (n / B) * L_bb > ~2
            # (measured: geometric divergence on ill-conditioned dense data
            # with small lambda; fixed by this estimator).
            grad_est_b = sum_gc / bw + state.g_sum_intercept
            intercept = state.intercept - gamma * config.intercept_decay * grad_est_b
            g_sum_i = state.g_sum_intercept + sum_gc / w_total
        else:
            g_sum_i = state.g_sum_intercept
            intercept = state.intercept

        new_state = SagaState(w_new, intercept, g_mem, g_sum, g_sum_i)
        if config.step_barrier:
            new_state = jax.lax.optimization_barrier(new_state)
        return new_state

    return step_xla


def _refresh_g_sum(x, xc, weights, w_total, state: SagaState, config: SolverConfig) -> SagaState:
    """Exact recompute g_sum = (1/W) X_eff^T g_mem — one matmul that resets
    float32 accumulation drift in the running gradient average."""
    if isinstance(x, (PaddedCSR, HybridCSR)):
        g_sum_t = x.matvec_T(state.g_mem)  # (p, k)
        g_sum = g_sum_t.T / w_total
    else:
        g_sum = jnp.dot(state.g_mem.T, x, preferred_element_type=x.dtype) / w_total
    col_sum = jnp.sum(state.g_mem, axis=0)  # (k,)
    if xc is not None:
        g_sum = g_sum - jnp.outer(col_sum, xc.astype(g_sum.dtype)) / w_total
    g_sum = _psum(g_sum, config)
    col_sum = _psum(col_sum, config)
    return state._replace(g_sum=g_sum, g_sum_intercept=col_sum / w_total)


def _make_epoch(x, y, weights, xc, w_total, family, penalty, config: SolverConfig, offs=None, pf=None, box=None):
    n_pad = y.shape[0]
    B = config.batch_size
    assert n_pad % B == 0, "n_pad must be a multiple of batch_size"
    n_batches = n_pad // B
    step = _make_step(x, y, weights, xc, w_total, family, penalty, config, offs=offs, pf=pf, box=box)

    def epoch(state: SagaState, key, gamma, l1, l2, it=None):
        if config.axis_name is not None:
            # distinct sample order per shard
            key = jax.random.fold_in(key, jax.lax.axis_index(config.axis_name))
        if config.sampling == "block":
            # contiguous blocks in random order: in-order reads instead of
            # row gathers (rows are pre-shuffled once by fit())
            xs = jax.random.permutation(key, n_batches) * B
        else:
            xs = jax.random.permutation(key, n_pad).reshape(n_batches, B)

        def body(state, sel):
            return step(state, (gamma, l1, l2), sel), None

        state, _ = jax.lax.scan(body, state, xs, unroll=config.scan_unroll)
        if config.g_sum_refresh:
            every = config.g_sum_refresh_every
            if every <= 1 or it is None:
                state = _refresh_g_sum(x, xc, weights, w_total, state, config)
            else:
                # periodic exact refresh: skip the full-matrix re-stream on
                # most epochs (same fixed point; f32 drift over a few epochs
                # is orders of magnitude below the coefficient tolerance)
                state = jax.lax.cond(
                    (it + 1) % every == 0,
                    lambda s: _refresh_g_sum(x, xc, weights, w_total, s, config),
                    lambda s: s,
                    state,
                )
        return state

    return epoch


# ---------------------------------------------------------------------------
# path driver: warm-started scan over the lambda sequence
# ---------------------------------------------------------------------------


class PathResults(NamedTuple):
    w: jnp.ndarray  # (n_lambda, k, p)   on the standardized scale
    intercept: jnp.ndarray  # (n_lambda, k)
    deviance: jnp.ndarray  # (n_lambda,)
    n_epochs: jnp.ndarray  # (n_lambda,) int32
    return_codes: jnp.ndarray  # (n_lambda,) int32: 0 converged, 1 hit max_iter
    losses: jnp.ndarray  # (n_lambda, max_iter) epoch losses (debug; else (n_lambda, 0))
    clamp_gap: jnp.ndarray  # (n_lambda,) exact-vs-solver loss gap (poisson clamp; else 0)
    #: relative change max|dw|/max|w| at the LAST epoch — discriminates a
    #: code-1 exit that was converging slowly (final_change barely above
    #: tol) from one that was oscillating (orders of magnitude above); the
    #: chunked-path/screening step backoff keys on this
    final_change: jnp.ndarray  # (n_lambda,)


@partial(jax.jit, static_argnames=("family", "penalty", "config"))
def fit_path(
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
    family: Family,
    penalty: Penalty,
    config: SolverConfig,
    offs=None,
    pf=None,
    box=None,
) -> tuple[SagaState, jnp.ndarray, PathResults]:
    """Fit the whole lambda path in one compiled computation.

    Mirrors the reference's path loop with warm starts
    (reference src/sgdnet.cpp:217-273): state (w, intercept, g_mem, g_sum)
    carries from one lambda to the next; each lambda runs epochs under a
    while_loop until the relative-change convergence criterion
    max|dw| / max|w| <= tol (reference src/utils.h:240-262) or max_iter.

    `offs` is an optional fixed (n_pad, k) offset added to every linear
    predictor (extension; documented-but-unimplemented in the reference,
    R/sgdnet.R:341-342).  `pf` is an optional (p,) per-feature penalty-factor
    vector and `box` an optional (lo, hi) pair of (k, p) coefficient bounds
    on the solver's standardized scale (glmnet `penalty.factor` /
    `lower.limits`/`upper.limits` semantics; both absent in the reference).
    """
    with jax.default_matmul_precision(config.matmul_precision):
        return _fit_path_impl(
            x, y, weights, xc, gammas, l1s, l2s, tol, key, state0, family, penalty, config, offs,
            pf, box,
        )


def _fit_path_impl(x, y, weights, xc, gammas, l1s, l2s, tol, key, state0, family, penalty, config, offs=None, pf=None, box=None):
    w_total = jnp.maximum(_psum(jnp.sum(weights), config), 1e-12)
    epoch_fn = _make_epoch(x, y, weights, xc, w_total, family, penalty, config, offs=offs, pf=pf, box=box)
    max_iter = config.max_iter

    def fit_one(state: SagaState, gamma, l1, l2, lam_key, tol_eff=None):
        # tol_eff: the relative-change criterion is scale-blind to the step
        # size — halving gamma halves every per-epoch |dw| and the SAME tol
        # then fires immediately on a warm start ("sham convergence",
        # measured: a gamma/2 retry exiting after ~3 epochs far from the
        # solution).  Retries therefore pass tol scaled by their step
        # multiplier so equivalent true progress is required.
        t_conv = tol if tol_eff is None else tol_eff
        losses0 = jnp.full((max_iter if config.debug else 0,), jnp.nan, dtype=state.w.dtype)

        def cond(carry):
            _, _, it, done, _, _ = carry
            return jnp.logical_not(done) & (it < max_iter)

        def body(carry):
            state, w_prev, it, _, losses, _ = carry
            ekey = jax.random.fold_in(lam_key, it)
            state = epoch_fn(state, ekey, gamma, l1, l2, it=it)
            max_change = jnp.max(jnp.abs(state.w - w_prev))
            max_size = jnp.max(jnp.abs(state.w))
            # divergence guard: once w or the intercept goes non-finite the
            # naive check would pass (inf <= tol * inf is True) and report a
            # CONVERGED code on garbage — measured on an inflated-step CPU
            # repro (tests/test_backoff.py).  A non-finite epoch is terminal
            # (inf/nan cannot recover through the prox), so exit, report
            # final_change = +inf, and let fit_one clamp it to max_iter so
            # the lambda lands as code 1 for the caller and the step-backoff
            # detector.
            finite = (
                jnp.isfinite(max_size)
                & jnp.isfinite(max_change)
                & jnp.all(jnp.isfinite(state.intercept))
            )
            all_zero = (max_size == 0.0) & (max_change == 0.0)
            no_change = finite & (max_size != 0.0) & (max_change <= t_conv * max_size)
            done = all_zero | no_change | jnp.logical_not(finite)
            rel = jnp.where(
                finite & (max_size > 0.0),
                max_change / jnp.maximum(max_size, 1e-30),
                jnp.where(finite, 0.0, jnp.inf),
            )
            if config.debug:
                loss = _dataset_loss(x, y, weights, xc, state.w, state.intercept, family, config, offs=offs) / w_total
                losses = losses.at[it].set(loss)
            return (state, state.w, it + 1, done, losses, rel)

        init = (
            state, state.w, jnp.int32(0), jnp.asarray(False), losses0,
            jnp.zeros((), state.w.dtype),
        )
        state, _, it, _, losses, rel = jax.lax.while_loop(cond, body, init)
        # a divergence exit (rel = inf) must read as NOT converged
        it = jnp.where(jnp.isinf(rel), jnp.int32(max_iter), it)
        return state, it, losses, rel

    # poisson: the exact reporting loss differs from the clamped solver loss
    # wherever the smoothness clamp is active — surface the gap per lambda so
    # fit() can warn when the clamp touched the reported solution
    track_clamp_gap = family.loss_report.__func__ is not Family.loss_report

    def _dev(s, report=True):
        return 2.0 * _dataset_loss(
            x, y, weights, xc, s.w, s.intercept, family, config, offs=offs, report=report
        )

    def _lmean(s):
        """Weighted mean SOLVER loss at a state (one data pass)."""
        return _dataset_loss(
            x, y, weights, xc, s.w, s.intercept, family, config, offs=offs, report=False
        ) / w_total

    def _objective(s, lmean, l1, l2):
        """Penalized objective: mean loss + l1*P1(w) + l2/2*||w||_pf^2.
        Attempts MUST be compared on this, not on deviance — a smaller-step
        under-shrunk iterate can have lower deviance while being farther
        from the penalized solution (measured: sharded poisson cascade,
        tests/test_poisson.py::test_sharded_equals_single)."""
        sq = s.w * s.w
        if pf is not None:
            sq = sq * pf
        return lmean + l1 * penalty.value(s.w, pf) + 0.5 * l2 * jnp.sum(sq)

    def fit_one_robust(state_in, gamma, l1, l2, lam_key, bk):
        """fit_one with in-program oscillation recovery (config.step_backoff).

        Any code-1 exit (hit max_iter) is retried once from the same
        warm-start state with the step halved; a second halving is spent
        only when the exit is truly suspicious — final relative change far
        above tol, or non-finite (divergence reports final_change = inf) —
        the signature of oscillation rather than slow convergence.  The
        attempt with the lowest PENALIZED objective is kept, so a
        slow-but-monotone code-1 fit keeps its original trajectory unless
        the retry genuinely lands closer to the solution; the halving
        sticks for deeper lambdas (via the returned `bk`) only when the
        winning retry actually CONVERGED — a still-code-1 winner must not
        ratchet the step down the whole path.  Implemented
        as a while_loop over attempts so the epoch program is traced exactly
        once.  All attempts count toward npasses.  Returns the kept
        attempt's mean solver loss so the caller can derive the deviance
        without another data pass.
        """
        losses0 = jnp.full((max_iter if config.debug else 0,), jnp.nan, dtype=state_in.w.dtype)
        dt = state_in.w.dtype

        def acond(c):
            attempt, stop = c[0], c[1]
            return jnp.logical_not(stop) & (attempt < 3)

        def abody(c):
            attempt, _, b_state, b_it, b_losses, b_rel, b_code, b_obj, b_lm, bk_out, tot = c
            gmul = bk * (0.5 ** attempt.astype(dt))
            # attempt 0 must use lam_key ITSELF so the no-retry trajectory is
            # bit-identical to the pre-backoff engine (fold_in(k, 0) != k);
            # retries fold in the attempt index for fresh permutations
            akey = jnp.where(
                attempt == 0, lam_key, jax.random.fold_in(lam_key, attempt)
            )
            state_new, it_new, losses_new, rel_new = fit_one(
                state_in, gamma * gmul, l1, l2, akey,
                tol_eff=tol * jnp.maximum(gmul, 0.25),
            )
            code_new = it_new >= max_iter
            # a diverged attempt (non-finite objective) must never win — and
            # must not poison the warm-start state for deeper lambdas: if
            # every attempt diverges, the best stays the (finite) input
            # state with an honest code-1 report
            lm_new = _lmean(state_new)
            obj_new = _objective(state_new, lm_new, l1, l2)
            obj_new = jnp.where(jnp.isfinite(obj_new), obj_new, jnp.asarray(jnp.inf, dt))
            better = obj_new < b_obj
            pick = lambda a, b: jax.tree_util.tree_map(
                lambda u, v: jnp.where(better, u, v), a, b
            )
            b_state = pick(state_new, b_state)
            b_it = jnp.where(better, it_new, b_it)
            b_losses = jnp.where(better, losses_new, b_losses)
            b_rel = jnp.where(better, rel_new, b_rel)
            b_code = jnp.where(better, code_new, b_code)
            b_obj = jnp.where(better, obj_new, b_obj)
            b_lm = jnp.where(better, lm_new, b_lm)
            bk_out = jnp.where(
                (attempt > 0) & better & jnp.logical_not(code_new), gmul, bk_out
            )
            # retry policy: ANY code-1 exit earns one halved-step retry (the
            # objective guard keeps quality monotone; measured: lam[25..29]
            # of the bench path exit code-1 with final_change only a few x
            # tol yet converge cleanly at gamma/2 — a suspicious-only rule
            # never fires there).  A SECOND halving is spent only on a truly
            # suspicious exit (oscillation/divergence signature).
            suspicious = code_new & (rel_new > 10.0 * tol)
            retry = jnp.where(attempt == 0, code_new, suspicious)
            return (
                attempt + 1, jnp.logical_not(retry), b_state, b_it,
                b_losses, b_rel, b_code, b_obj, b_lm, bk_out, tot + it_new,
            )

        # the initial "best" is the untouched input state at obj=inf: any
        # finite attempt beats it, and if every attempt diverges the path
        # continues from the finite warm start with it=max_iter (code 1)
        # and an inf deviance (computing the true warm-start loss here would
        # cost a data pass on EVERY lambda for a corner that cannot happen
        # without divergence)
        init = (
            jnp.int32(0), jnp.asarray(False), state_in, jnp.int32(max_iter), losses0,
            jnp.asarray(jnp.inf, dt), jnp.asarray(True), jnp.asarray(jnp.inf, dt),
            jnp.asarray(jnp.inf, dt), bk, jnp.int32(0),
        )
        c = jax.lax.while_loop(acond, abody, init)
        _, _, b_state, b_it, b_losses, b_rel, b_code, _, b_lm, bk_out, tot = c
        return b_state, b_it, b_losses, b_rel, b_code, b_lm, bk_out, tot

    def scan_body(carry, xs):
        state, n_iter, bk = carry
        gamma, l1, l2, i = xs
        lam_key = jax.random.fold_in(key, i)
        if config.step_backoff:
            state, it, losses, rel, code, lmean, bk, att_it = fit_one_robust(
                state, gamma, l1, l2, lam_key, bk
            )
            dev_solver = 2.0 * w_total * lmean
            if track_clamp_gap:
                dev = _dev(state)  # exact reporting deviance (poisson)
                gap = dev - dev_solver
            else:  # reporting loss == solver loss: no extra pass needed
                dev = dev_solver
                gap = jnp.zeros((), dev.dtype)
        else:
            state, it, losses, rel = fit_one(state, gamma, l1, l2, lam_key)
            code = it >= max_iter
            dev = _dev(state)
            att_it = it
            if track_clamp_gap:
                gap = dev - _dev(state, report=False)
            else:
                gap = jnp.zeros((), dev.dtype)
        out = (state.w, state.intercept, dev, it, code.astype(jnp.int32), losses, gap, rel)
        return (state, n_iter + att_it, bk), out

    n_lambda = gammas.shape[0]
    (state, n_iter, _), outs = jax.lax.scan(
        scan_body,
        (state0, jnp.int32(0), jnp.ones((), gammas.dtype)),
        (gammas, l1s, l2s, jnp.arange(n_lambda)),
    )
    results = PathResults(*outs)
    return state, n_iter, results
