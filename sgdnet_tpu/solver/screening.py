"""Sequential strong-rule screening for the lambda path.

The reference has no screening (its path loop always touches all p
features); the rebuild's north star lists screening as a subsystem.  This
implements the sequential strong rule (Tibshirani et al. 2012): when moving
from lambda_{k-1} to lambda_k, feature j can be discarded if

    score_j  =  || (1/W) X_eff^T g ||  <  pf_j * (2*l1_k - l1_{k-1})

where g are the per-sample gradients at the lambda_{k-1} solution, the norm
is over classes (plain |.| for single-response, the group L2 norm for
group-lasso penalties), and pf_j is the per-feature penalty factor
(features with pf_j = 0 are unpenalized and always active).  The rule is
safe-checked: after fitting on the screened set, the full KKT conditions
are verified and any violating feature is added back and the lambdas
re-fit — the result is exact, not heuristic.

Accelerator adaptations (layout-generic + batched):

* **Any layout.** The active set is materialized as a DENSE (n_pad, K+1)
  column subset regardless of the input layout — once screening works, K is
  small and a dense fully-centered block is the fastest thing the solver
  can consume.  Dense inputs gather columns; PaddedCSR scatters its
  nonzeros through a col->slot lookup; HybridCSR does head-gather +
  tail-scatter.  Centering is applied directly to the subset (it is dense
  now), so the solver runs with no correction term.
* **Static shapes.** Active sets pad into power-of-two buckets ending at a
  dedicated all-zero dummy column, so each bucket size compiles once.
* **Lambda groups.** Consecutive lambdas are screened and fitted in GROUPS
  sharing one active set (union strong rule at the group's smallest
  lambda): one fit_path call and one batched KKT check per group instead
  of per lambda, cutting host round-trips by the group size.
* **Penalty factors / box limits.** pf scales both the screening threshold
  and the KKT check; box limits are sliced onto the active subset.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from sgdnet_tpu.core.sparse import HybridCSR, PaddedCSR
from sgdnet_tpu.solver.saga import SagaState, SolverConfig, fit_path, init_state


def _bucket(size: int, minimum: int = 128) -> int:
    b = minimum
    while b < size:
        b *= 2
    return b


def _full_lp(x, xc, w_dev, b_dev, dtype, offs=None):
    """Linear predictors on the full data, any layout; (n_pad, k)."""
    if isinstance(x, (PaddedCSR, HybridCSR)):
        lp = x.matmul_dense(w_dev.T.astype(dtype)).astype(dtype)
    else:
        lp = jnp.dot(x, w_dev.T, preferred_element_type=dtype)
    if xc is not None:
        lp = lp - jnp.dot(w_dev, xc.astype(w_dev.dtype))
    if offs is not None:
        lp = lp + offs.astype(dtype)
    return lp + b_dev


def _xtg(x, xc, g, w_total, dtype):
    """(1/W) X_eff^T g with the sparse centering correction; (k, p)."""
    if isinstance(x, (PaddedCSR, HybridCSR)):
        xtg = x.matvec_T(g.astype(dtype)).T.astype(dtype) / w_total
    else:
        xtg = jnp.dot(g.T, x, preferred_element_type=dtype) / w_total
    if xc is not None:
        xtg = xtg - jnp.outer(jnp.sum(g, axis=0), xc.astype(xtg.dtype)) / w_total
    return xtg


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("dtype",))
def _subset_hybrid_jit(head, head_scale, t_idx, t_val, slot_dev, cols, xc, dtype):
    """Jitted (n_pad, K) subset build for HybridCSR — MUST be jitted: the
    eager op chain materializes several head-sized f32 temporaries (gather,
    astype, mask multiply) and OOMed a 16 GB chip at bench scale."""
    n_pad = head.shape[0]
    d = head.shape[1]
    p = slot_dev.shape[0] - 1
    K = cols.shape[0]
    head_cols = jnp.where(cols < d, cols, 0)
    head_part = head[:, head_cols].astype(dtype) * (cols < d)[None, :]
    if head_scale is not None:
        head_part = head_part * head_scale[head_cols].astype(dtype)[None, :]
    rows = jnp.broadcast_to(jnp.arange(n_pad)[:, None], t_idx.shape)
    tail_part = (
        jnp.zeros((n_pad, K + 1), dtype)
        .at[rows, slot_dev[t_idx]]
        .add(t_val.astype(dtype))[:, :K]
    )
    sub = head_part + tail_part
    if xc is not None:
        c_sub = jnp.where(cols < p, xc.astype(dtype)[jnp.minimum(cols, p - 1)], 0.0)
        sub = sub - c_sub[None, :]
    return sub


@_partial(jax.jit, static_argnames=("dtype",))
def _subset_padded_jit(t_idx, t_val, slot_dev, cols, xc, dtype):
    n_pad = t_idx.shape[0]
    p = slot_dev.shape[0] - 1
    K = cols.shape[0]
    rows = jnp.broadcast_to(jnp.arange(n_pad)[:, None], t_idx.shape)
    sub = (
        jnp.zeros((n_pad, K + 1), dtype)
        .at[rows, slot_dev[t_idx]]
        .add(t_val.astype(dtype))[:, :K]
    )
    if xc is not None:
        c_sub = jnp.where(cols < p, xc.astype(dtype)[jnp.minimum(cols, p - 1)], 0.0)
        sub = sub - c_sub[None, :]
    return sub


@_partial(jax.jit, static_argnames=("dtype",))
def _subset_dense_jit(x, cols, xc, dtype):
    p = x.shape[1]
    sub = jnp.where(
        (cols < p)[None, :], x[:, jnp.minimum(cols, p - 1)].astype(dtype), 0.0
    )
    if xc is not None:
        c_sub = jnp.where(cols < p, xc.astype(dtype)[jnp.minimum(cols, p - 1)], 0.0)
        sub = sub - c_sub[None, :]
    return sub


def _column_subset(x, xc, cols_np: np.ndarray, p: int, dtype):
    """Dense, fully-centered (n_pad, K+1) block of the selected columns.

    cols_np has K entries in [0, p]; index p selects the all-zero dummy.
    The returned block needs NO centering correction (pad rows carry weight
    0, so their nonzero centered values are inert).  The device work runs
    in jitted builders (one compile per bucket size K)."""
    K = len(cols_np)
    cols = jnp.asarray(cols_np)
    if isinstance(x, (HybridCSR, PaddedCSR)):
        slot = np.full(p + 1, K, dtype=np.int32)
        real = cols_np < p
        slot[cols_np[real]] = np.arange(K, dtype=np.int32)[real]
        slot_dev = jnp.asarray(slot)
        if isinstance(x, HybridCSR):
            return _subset_hybrid_jit(
                x.head, x.head_scale, x.tail.indices, x.tail.values,
                slot_dev, cols, xc, dtype=dtype,
            )
        return _subset_padded_jit(x.indices, x.values, slot_dev, cols, xc, dtype=dtype)
    return _subset_dense_jit(x, cols, xc, dtype=dtype)


def screened_path(
    x,  # standardized design (dense, PaddedCSR, or HybridCSR), padded rows
    y,
    weights,
    gammas,
    l1s,
    l2s,
    tol,
    key,
    family,
    penalty,
    config: SolverConfig,
    xc=None,  # sparse centering correction (center/scale), or None
    pf=None,  # (p,) penalty factors (solver scale), or None
    box=None,  # ((k, p) lo, (k, p) hi) standardized-scale bounds, or None
    always_inactive=None,  # (p,) bool — excluded features, pinned to zero
    offs=None,  # (n_pad, k) linear-predictor offsets, or None
    intercept0=None,  # (k,) initial intercept (offset-aware null), or None
    group_size: int = 4,
    kkt_slack: float = 1e-5,
    max_kkt_rounds: int = 3,
    full_fallback_frac: float = 0.35,
    subset_mem_budget: float = 8e9,
    auto_full_tail: bool = False,
    full_tail_chunk: int | None = None,
):
    """Strong-rule screened warm-started path.  Returns (w_path (nl, k, p),
    intercept_path (nl, k), deviance (nl,), n_epochs (nl,), return_codes,
    total_epochs, stats dict).

    `auto_full_tail` implements the screen="auto" regime policy (round 5):
    active sets only grow along a decreasing lambda path, so the FIRST
    group that trips the dense-regime fallback marks the point past which
    screening stops paying for good.  Instead of falling back group by
    group (one dispatch + one full-data score pass per group), the remainder of the path runs as
    ONE warm-started full-layout fit_path call, i.e. exactly the
    screen=False schedule.  stats["full_tail_from"] records the switch
    index (None if the whole path stayed screened).  `full_tail_chunk`
    splits that tail into warm-started chunks of the given number of
    lambdas, one dispatch each — the same knob as fit()'s `lambda_chunk`,
    which fit() forwards here."""
    n_pad = x.shape[0]
    p = x.shape[1]
    k = family.n_classes
    dtype = y.dtype
    nl = len(np.asarray(l1s))
    w_total = jnp.maximum(jnp.sum(weights), 1e-12)

    pf_np = np.ones(p) if pf is None else np.asarray(pf, dtype=np.float64)
    excl_np = (
        np.zeros(p, dtype=bool) if always_inactive is None else np.asarray(always_inactive)
    )

    w_full = np.zeros((k, p), dtype=np.float64)
    if intercept0 is not None:
        intercept = np.asarray(intercept0, dtype=np.float64)
    else:
        intercept = np.asarray(
            family.null_intercept(y.astype(jnp.float64), config.fit_intercept, weights.astype(jnp.float64))
        )
    g_mem = jnp.zeros((n_pad, k), dtype)

    # x / y / weights / offs are jit ARGUMENTS, not closure captures: a
    # captured device array is embedded into the lowered HLO as a literal
    # constant, which bloats compilation and the executable
    @jax.jit
    def _scores_impl(x, xc, offs, y, weights, w_dev, b_dev):
        lp = _full_lp(x, xc, w_dev, b_dev, dtype, offs=offs)
        g = family.gradient(lp, y) * weights[:, None]  # (n_pad, k)
        xtg = _xtg(x, xc, g, w_total, dtype)
        return jnp.sqrt(jnp.sum(xtg.astype(jnp.float64) ** 2, axis=0))

    def gradient_scores(w_dev, b_dev):
        return _scores_impl(x, xc, offs, y, weights, w_dev, b_dev)

    @jax.jit
    def _group_scores_impl(x, xc, offs, y, weights, w_group, b_group):
        """Scores at each of G candidate solutions: (G, p)."""

        def one(carry, i):
            lp = _full_lp(x, xc, w_group[i], b_group[i], dtype, offs=offs)
            g = family.gradient(lp, y) * weights[:, None]
            xtg = _xtg(x, xc, g, w_total, dtype)
            return carry, jnp.sqrt(jnp.sum(xtg.astype(jnp.float64) ** 2, axis=0))

        _, s = jax.lax.scan(one, 0, jnp.arange(w_group.shape[0]))
        return s

    def group_scores(w_group, b_group):
        return _group_scores_impl(x, xc, offs, y, weights, w_group, b_group)

    @jax.jit
    def _deviance_impl(x, xc, offs, y, weights, w_dev, b_dev):
        lp = _full_lp(x, xc, w_dev, b_dev, dtype, offs=offs)
        losses = family.loss_report(lp, y) * weights
        return 2.0 * jnp.sum(losses)

    def dataset_deviance(w_dev, b_dev):
        return _deviance_impl(x, xc, offs, y, weights, w_dev, b_dev)

    w_out = np.zeros((nl, k, p))
    b_out = np.zeros((nl, k))
    dev_out = np.zeros(nl)
    iters_out = np.zeros(nl, dtype=np.int32)
    codes_out = np.zeros(nl, dtype=np.int32)
    total_epochs = 0
    work_elems = 0  # design elements the solver actually streamed (see stats)
    active_hist = []
    kkt_rounds_hist = []

    l1s_np = np.asarray(l1s, dtype=np.float64)
    gammas_np = np.asarray(gammas, dtype=np.float64)
    l2s_np = np.asarray(l2s, dtype=np.float64)

    # work basis for a full-layout group: elements the solver streams per
    # epoch on the native layout (nnz for sparse layouts, n*p dense)
    if isinstance(x, (PaddedCSR, HybridCSR)):
        full_elems = x.total_nnz()
    else:
        full_elems = n_pad * p
    full_groups = 0

    # step backoff, sticky along the path — the same try-and-keep-the-better
    # policy as fit()'s chunked path (see there for the rationale and the
    # measured 0.22-relative-error failure this prevents)
    _bk = 0
    _tol_f = float(np.asarray(tol))
    full_tail_from = None  # lambda index where auto_full_tail switched, if it did
    in_full_tail = False

    def _fit_backoff(run_one, count_work):
        nonlocal _bk, total_epochs, work_elems

        def _account(out):
            nonlocal total_epochs, work_elems
            n_it = int(out[1])
            total_epochs += n_it
            work_elems += n_it * count_work

        def _suspicious(out):
            return bool(np.any(
                (np.asarray(out[2].return_codes) == 1)
                & (np.asarray(out[2].final_change) > 10.0 * _tol_f)
            ))

        def _better(a, b):
            """a strictly better than b: fewer non-converged lambdas, then
            lower total deviance."""
            ca = int((np.asarray(a[2].return_codes) == 1).sum())
            cb = int((np.asarray(b[2].return_codes) == 1).sum())
            if ca != cb:
                return ca < cb
            return float(np.asarray(a[2].deviance).sum()) < float(
                np.asarray(b[2].deviance).sum()
            )

        best = run_one(0.5 ** _bk, 0)
        _account(best)
        for _try in (1, 2):
            if not _suspicious(best):
                break
            cand = run_one(0.5 ** (_bk + 1), _try)
            _account(cand)
            if _better(cand, best):
                best = cand
                _bk += 1  # sticky only when the smaller step actually won
            else:
                break  # slow-but-stable fit: keep the original trajectory
        return best

    li = 0
    while li < nl:
        hi = min(li + group_size, nl)
        G = hi - li
        w_dev = jnp.asarray(w_full, dtype)
        b_dev = jnp.asarray(intercept, dtype)

        # Dense-regime fallback (round 4, measured on the bench workload):
        # once the strong rule keeps more than `full_fallback_frac` of the
        # features — OR the dense subset would exceed the subset memory
        # budget (~4 f32 buffers of (n_pad, K); a K=16384 bucket at n=100k
        # OOMed the 16 GB chip) — the column-subset strategy stops paying.
        # Fit such lambda groups on the full design in its native layout:
        # exact by construction (every feature present, KKT vacuous), still
        # warm-started, and the active-set machinery resumes for later
        # groups (it won't shrink along a path, but refits with custom
        # lambda orders can).  Defined before the scores pass so the
        # auto_full_tail fast path below can skip that pass entirely.
        def fit_group_full(active_count):
            nonlocal w_full, intercept, g_mem, full_groups
            from sgdnet_tpu.solver.saga import _refresh_g_sum

            state0 = SagaState(
                w=jnp.asarray(w_full, dtype),
                intercept=b_dev,
                g_mem=g_mem,
                g_sum=jnp.zeros((k, p), dtype),
                g_sum_intercept=jnp.zeros((k,), dtype),
            )
            state0 = _refresh_g_sum(x, xc, weights, jnp.asarray(w_total, dtype), state0, config)

            def run_one(gmul, _try):
                return fit_path(
                    x, y, weights, xc,
                    jnp.asarray(gammas_np[li:hi] * gmul, dtype),
                    jnp.asarray(l1s_np[li:hi], dtype),
                    jnp.asarray(l2s_np[li:hi], dtype),
                    jnp.asarray(tol, dtype),
                    jax.random.fold_in(key, li * 7 + 1000 * _try),
                    state0, family, penalty, config,
                    offs=offs, pf=pf, box=box,
                )

            state, n_it, results = _fit_backoff(run_one, int(full_elems))
            w_grp = np.asarray(results.w, dtype=np.float64)
            b_grp = np.asarray(results.intercept, dtype=np.float64)
            g_mem = state.g_mem
            w_out[li:hi] = w_grp
            b_out[li:hi] = b_grp
            dev_out[li:hi] = np.asarray(results.deviance, dtype=np.float64)
            iters_out[li:hi] = np.asarray(results.n_epochs, dtype=np.int32)
            codes_out[li:hi] = np.asarray(results.return_codes, dtype=np.int32)
            active_hist.append(int(active_count))
            kkt_rounds_hist.append(0)
            full_groups += 1
            w_full = w_grp[-1]
            intercept = b_grp[-1]

        if in_full_tail:
            # screen="auto" past the regime switch: pure full-layout
            # warm-started chunks, no scores pass, no strong rule
            hi = min(li + (full_tail_chunk or (nl - li)), nl)
            fit_group_full(p)
            li = hi
            continue

        scores = np.asarray(gradient_scores(w_dev, b_dev))

        # union of the per-lambda sequential strong rules over the group:
        # active if score >= pf * (2*l1_g - l1_{g-1}) for ANY lambda in the
        # group, i.e. score >= pf * min_g(2*l1_g - l1_{g-1}).  (The naive
        # group rule 2*l1_last - l1_prev goes NEGATIVE once the group spans
        # a lambda ratio > 2x and screens nothing.)  For g > li this uses
        # scores measured at the last fitted solution rather than at
        # lambda_{g-1}'s — a heuristic, but the batched KKT check below
        # keeps the result exact either way.  The lambda-max proxy at the
        # path start considers only penalized features (pf > 0), like the
        # lambda-path construction itself.
        if li > 0:
            l1_prev = l1s_np[li - 1]
        else:
            pen = (pf_np > 0) & ~excl_np
            l1_prev = float(np.max(scores[pen] / pf_np[pen])) if pen.any() else 0.0
        prevs = np.concatenate([[l1_prev], l1s_np[li : hi - 1]])
        threshold = float(np.min(2.0 * l1s_np[li:hi] - prevs))
        active = (
            (scores >= pf_np * threshold)
            | (np.abs(w_full).sum(axis=0) > 0)
            | (pf_np == 0)
        ) & ~excl_np

        K_limit = max(256, int(subset_mem_budget // (16 * n_pad)))
        if active.sum() > full_fallback_frac * p or _bucket(max(int(active.sum()), 1)) > K_limit:
            if auto_full_tail:
                # regime switch: run every remaining lambda full-layout
                # (the screen=False schedule), in warm-started chunks of
                # full_tail_chunk lambdas (or one dispatch if None)
                full_tail_from = li
                in_full_tail = True
                hi = min(li + (full_tail_chunk or (nl - li)), nl)
            fit_group_full(int(active.sum()))
            li = hi
            continue

        # KKT safety loop: the active set only grows, and once it reaches
        # the full feature set the violation check (which masks `~active`)
        # is empty by construction — so iterating UNTIL CLEAN terminates and
        # makes the "exact, not heuristic" docstring literally true.  Past
        # `max_kkt_rounds` (should not happen: one round per group is
        # typical) a RuntimeWarning flags the slow strong rule, but the
        # expansion continues rather than silently returning an inexact fit.
        kkt_round = 0
        _went_full = False
        while True:
            idx = np.flatnonzero(active)
            K = min(_bucket(max(len(idx), 1)), p)
            if K > K_limit or len(idx) > K:
                # KKT expansion outgrew the subset budget mid-group: finish
                # the group on the full native layout (exact, and bounded
                # memory — the old dense-everything fallback OOMed here)
                if auto_full_tail:
                    full_tail_from = li
                    in_full_tail = True
                    hi = min(li + (full_tail_chunk or (nl - li)), nl)
                fit_group_full(len(idx))
                _went_full = True
                break
            padded = np.full(K, p, dtype=np.int32)  # dummy column
            padded[: len(idx)] = idx[:K]

            x_sub = _column_subset(x, xc, padded, p, dtype)[:, :K]
            real = padded < p
            w_sub = jnp.asarray(w_full[:, np.minimum(padded, p - 1)] * real, dtype)
            pf_sub = (
                None
                if pf is None
                else jnp.asarray(np.where(real, pf_np[np.minimum(padded, p - 1)], 1.0), dtype)
            )
            box_sub = None
            if box is not None:
                lo = np.asarray(box[0])[:, np.minimum(padded, p - 1)]
                hi_b = np.asarray(box[1])[:, np.minimum(padded, p - 1)]
                lo = np.where(real[None, :], lo, 0.0)
                hi_b = np.where(real[None, :], hi_b, 0.0)
                box_sub = (jnp.asarray(lo, dtype), jnp.asarray(hi_b, dtype))
            # gradient average on the active set: one matvec
            g_sum_sub = jnp.dot(g_mem.T, x_sub, preferred_element_type=dtype) / w_total
            state0 = SagaState(
                w=w_sub,
                intercept=b_dev,
                g_mem=g_mem,
                g_sum=g_sum_sub,
                g_sum_intercept=jnp.sum(g_mem, axis=0) / w_total,
            )

            def run_one(gmul, _try, _x_sub=x_sub, _st=state0, _pf=pf_sub, _bx=box_sub,
                        _kr=kkt_round):
                return fit_path(
                    _x_sub, y, weights, None,
                    jnp.asarray(gammas_np[li:hi] * gmul, dtype),
                    jnp.asarray(l1s_np[li:hi], dtype),
                    jnp.asarray(l2s_np[li:hi], dtype),
                    jnp.asarray(tol, dtype),
                    jax.random.fold_in(key, li * 7 + _kr + 1000 * _try),
                    _st, family, penalty, config,
                    offs=offs, pf=_pf, box=_bx,
                )

            # work counter: the solver streamed the DENSE (n_pad, K) subset
            # (including bucket padding), not the full design — work done,
            # not coverage
            state, n_it, results = _fit_backoff(run_one, n_pad * K)
            # scatter each group solution back to full width
            w_grp_sub = np.asarray(results.w, dtype=np.float64)  # (G, k, K)
            w_grp = np.zeros((G, k, p))
            w_grp[:, :, padded[real]] = w_grp_sub[:, :, real]
            b_grp = np.asarray(results.intercept, dtype=np.float64)  # (G, k)
            g_mem_new = state.g_mem

            # batched KKT check: scores at each group solution vs its own l1
            s_grp = np.asarray(
                group_scores(jnp.asarray(w_grp, dtype), jnp.asarray(b_grp, dtype))
            )  # (G, p)
            viol = (
                (s_grp > pf_np[None, :] * l1s_np[li:hi, None] * (1 + kkt_slack))
                & ~active[None, :]
                & ~excl_np[None, :]
            ).any(axis=0)
            if not viol.any():
                g_mem = g_mem_new
                break
            active |= viol
            kkt_round += 1
            if kkt_round == max_kkt_rounds:
                import warnings

                warnings.warn(
                    f"strong-rule screening needed more than {max_kkt_rounds} "
                    f"KKT expansion rounds for lambdas [{li}, {hi}); continuing "
                    "until the KKT conditions are clean (the result stays exact, "
                    "but screening is saving little work on this problem)",
                    RuntimeWarning,
                    stacklevel=2,
                )

        if not _went_full:  # fit_group_full already wrote this group's outputs
            w_out[li:hi] = w_grp
            b_out[li:hi] = b_grp
            iters_out[li:hi] = np.asarray(results.n_epochs, dtype=np.int32)
            codes_out[li:hi] = np.asarray(results.return_codes, dtype=np.int32)
            for gi in range(G):
                dev_out[li + gi] = float(
                    dataset_deviance(jnp.asarray(w_grp[gi], dtype), jnp.asarray(b_grp[gi], dtype))
                )
            active_hist.append(int(active.sum()))
            kkt_rounds_hist.append(kkt_round)
            w_full = w_grp[-1]
            intercept = b_grp[-1]
        li = hi

    stats = {
        "active_per_group": active_hist,
        "mean_active": float(np.mean(active_hist)) if active_hist else 0.0,
        "p": p,
        # epochs x n_pad x K(bucket) summed over fit_path calls: the design
        # elements the solver streamed on its dense active-set subproblems —
        # the WORK basis for a screened fit's nnz_per_s (api/fit.py)
        "work_elems": work_elems,
        # every returned solution satisfied the full-width KKT conditions
        # (the expansion loop above runs until clean — exact by construction)
        "kkt_clean": True,
        "kkt_rounds_per_group": kkt_rounds_hist,
        # lambda groups fit on the FULL native layout because the strong
        # rule kept > full_fallback_frac of the features (dense path tail)
        "full_fallback_groups": full_groups,
        # screen="auto": lambda index where the remaining path switched to
        # one full-layout fit (None = the whole path stayed screened)
        "full_tail_from": full_tail_from,
    }
    return w_out, b_out, dev_out, iters_out, codes_out, total_epochs, stats
