"""Hybrid-layout planner (core/layout.py) and fit(hybrid_max_head="auto")."""

import numpy as np
import pytest
import scipy.sparse as sp

import sgdnet_tpu as st
from sgdnet_tpu.core.layout import ELEM_OP_S, STREAM_BYTES_PER_S, TAIL_OPS_PER_ENTRY, plan_layout


def _zipf_sparse(n=5000, p=2000, nnz_row=20, seed=0):
    rng = np.random.default_rng(seed)
    weights = (np.arange(p) + 10.0) ** -1.15
    cdf = np.cumsum(weights) / weights.sum()
    cols = np.searchsorted(cdf, rng.random((n, nnz_row))).clip(0, p - 1)
    rows = np.repeat(np.arange(n), nnz_row)
    vals = rng.normal(size=n * nnz_row)
    return sp.csr_matrix((vals, (rows, cols.ravel())), shape=(n, p))


def test_plan_break_even_is_optimal_on_grid():
    """The planner's D beats halving or doubling it under its own model."""
    x = _zipf_sparse()
    plan = plan_layout(x, batch_size=512, head_itemsize=1)
    col_nnz = np.bincount(x.tocsr().indices, minlength=x.shape[1])
    cum = np.cumsum(np.sort(col_nnz)[::-1]).astype(float)
    total = cum[-1]
    n_pad = ((x.shape[0] + 511) // 512) * 512
    passes = 2.0 + 1.0 / 8

    def cost(d):
        d = min(max(d, 1), x.shape[1])
        tail = total - cum[d - 1]
        return passes * n_pad * d / STREAM_BYTES_PER_S + tail * TAIL_OPS_PER_ENTRY * ELEM_OP_S

    c0 = cost(plan.max_head)
    assert c0 <= cost(plan.max_head // 2) + 1e-12
    assert c0 <= cost(min(plan.max_head * 2, x.shape[1])) + 1e-12
    assert plan.max_head % 128 == 0 or plan.max_head == x.shape[1]
    assert 0.0 < plan.coverage <= 1.0


def test_plan_respects_budget_and_itemsize():
    x = _zipf_sparse()
    small = plan_layout(x, batch_size=512, head_itemsize=4, hbm_budget=2e6)
    big = plan_layout(x, batch_size=512, head_itemsize=4, hbm_budget=1e12)
    n_pad = ((x.shape[0] + 511) // 512) * 512
    assert small.head_bytes <= 2e6 + n_pad * 128 * 4  # lane-align slack
    assert small.max_head <= big.max_head
    # cheaper storage -> wider head (break-even drops)
    int8 = plan_layout(x, batch_size=512, head_itemsize=1, hbm_budget=1e12)
    assert int8.max_head >= big.max_head


def test_fit_auto_max_head():
    """hybrid_max_head='auto' plans the split and fits correctly."""
    x = _zipf_sparse(n=600, p=300, nnz_row=10, seed=3)
    rng = np.random.default_rng(0)
    wt = np.zeros(300); wt[:4] = [1.0, -0.8, 0.5, -0.3]
    y = np.asarray(x @ wt).ravel() + 0.1 * rng.normal(size=600)
    f_auto = st.fit(x, y, family="gaussian", alpha=0.5, nlambda=6,
                    batch_size=64, hybrid=True, hybrid_max_head="auto",
                    thresh=1e-5, dtype=np.float64)
    f_ref = st.fit(x, y, family="gaussian", alpha=0.5,
                   lambda_path=f_auto.lambda_, batch_size=64, hybrid=False,
                   thresh=1e-5, dtype=np.float64)
    scale = max(np.abs(f_ref.beta).max(), 1.0)
    np.testing.assert_allclose(f_auto.beta, f_ref.beta, atol=2e-3 * scale)
