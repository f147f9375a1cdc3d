"""Performance-mode options keep the solver's fixed point.

Two opt-in throughput knobs:
  * `g_sum_refresh_every=k` — the exact gradient-average recompute (which
    re-streams the whole design matrix) runs every k epochs instead of
    every epoch.  Same fixed point; only float accumulation-drift cadence
    changes, so coefficients must match the default at the usual tolerance.
  * `hybrid_head_dtype=bfloat16` — the dense head of a HybridCSR layout is
    stored in bf16 (matmuls still accumulate in f32).  This perturbs the
    data by ~0.4% relative, so the contract intentionally loosens to ~1e-2.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import sgdnet_tpu as st
from sgdnet_tpu.core.sparse import HybridCSR
from tests.helpers import random_data


def _sparse_problem(n=300, p=40, family="binomial", seed=11):
    x, y = random_data(n=n, p=p, family=family, density=0.3, seed=seed)
    return sp.csr_matrix(x), y


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
def test_refresh_every_matches_default(family):
    xs, y = _sparse_problem(family=family)
    kw = dict(family=family, alpha=0.5, nlambda=8, batch_size=32, dtype=np.float64, seed=3)
    ref = st.fit(xs, y, g_sum_refresh_every=1, **kw)
    lazy = st.fit(xs, y, g_sum_refresh_every=4, **kw)
    scale = max(np.abs(ref.beta).max(), 1.0)
    np.testing.assert_allclose(lazy.beta, ref.beta, atol=2e-3 * scale)
    np.testing.assert_allclose(lazy.a0, ref.a0, atol=2e-3 * max(np.abs(ref.a0).max(), 1.0))


def test_refresh_every_dense_path():
    x, y = random_data(n=200, p=12, family="gaussian", seed=5)
    kw = dict(alpha=1.0, nlambda=6, batch_size=16, dtype=np.float64, seed=1)
    ref = st.fit(x, y, g_sum_refresh_every=1, **kw)
    lazy = st.fit(x, y, g_sum_refresh_every=3, **kw)
    scale = max(np.abs(ref.beta).max(), 1.0)
    np.testing.assert_allclose(lazy.beta, ref.beta, atol=2e-3 * scale)


def test_bf16_head_close_to_f32():
    """bf16 head storage converges to the same solution at the loosened
    (~1e-2 relative) contract; solver accumulation stays f32."""
    import jax.numpy as jnp

    xs, y = _sparse_problem(n=400, p=64, family="binomial", seed=21)
    kw = dict(
        family="binomial", alpha=0.5, nlambda=6, batch_size=32, seed=7,
        hybrid=True, hybrid_max_head=32, hybrid_coverage=0.8,
    )
    ref = st.fit(xs, y, dtype=np.float32, **kw)
    b16 = st.fit(xs, y, dtype=np.float32, hybrid_head_dtype=jnp.bfloat16, **kw)
    scale = max(np.abs(ref.beta).max(), 1.0)
    assert np.max(np.abs(b16.beta - ref.beta)) <= 2e-2 * scale
    assert np.max(np.abs(b16.a0 - ref.a0)) <= 2e-2 * max(np.abs(ref.a0).max(), 1.0)


def test_bf16_hybrid_layout_exact_split():
    """The bf16 head layout is still an exact column split (values rounded
    to bf16, tail untouched at full precision)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    x = rng.normal(size=(50, 20)) * (rng.random((50, 20)) < 0.4)
    xh, perm = HybridCSR.split_columns(
        sp.csr_matrix(x), coverage=0.6, max_head=8, head_dtype=jnp.bfloat16
    )
    assert xh.head.dtype == jnp.bfloat16
    assert xh.tail.values.dtype == jnp.float32
    dense = np.asarray(xh.head.astype(jnp.float32)) + np.asarray(
        xh.tail.to_dense()[:, : xh.n_cols]
    )
    np.testing.assert_allclose(dense, x[:, perm], atol=4e-3 * max(np.abs(x).max(), 1))
    # matvec_T accumulates wider than bf16
    v = rng.normal(size=(50, 2)).astype(np.float32)
    got = np.asarray(xh.matvec_T(jnp.asarray(v)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, x[:, perm].T @ v, atol=2e-2 * np.abs(x.T @ v).max())


def test_int8_head_close_to_f32():
    """int8 head storage (per-column symmetric quantization, scales folded
    into w) converges near the f32 solution; the perturbation is ~1/254 of
    each column's max, so the contract loosens to ~4e-2 relative."""
    xs, y = _sparse_problem(n=400, p=64, family="binomial", seed=23)
    kw = dict(
        family="binomial", alpha=0.5, nlambda=6, batch_size=32, seed=7,
        hybrid=True, hybrid_max_head=32, hybrid_coverage=0.8,
    )
    ref = st.fit(xs, y, dtype=np.float32, **kw)
    q8 = st.fit(xs, y, dtype=np.float32, hybrid_head_dtype="int8", **kw)
    scale = max(np.abs(ref.beta).max(), 1.0)
    assert np.max(np.abs(q8.beta - ref.beta)) <= 4e-2 * scale
    assert np.max(np.abs(q8.a0 - ref.a0)) <= 4e-2 * max(np.abs(ref.a0).max(), 1.0)


def test_int8_head_exact_when_integer_data():
    """With integer data whose column max is 127 and standardize=False, the
    int8 quantization is EXACT, so the int8 fit must reproduce the f32 fit
    at solver precision — isolates the plumbing from quantization noise."""
    rng = np.random.default_rng(4)
    n, p = 256, 48
    x = rng.integers(-5, 6, size=(n, p)).astype(np.float64)
    x[:, rng.random(p) < 0.5] *= rng.integers(1, 4)
    x[0, :] = 127  # pin every column's |max| at 127 -> scale exactly 1
    w_true = np.zeros(p)
    w_true[:4] = [0.02, -0.015, 0.01, 0.005]
    yp = 1.0 / (1.0 + np.exp(-(x @ w_true)))
    y = (rng.random(n) < yp).astype(np.float64)
    kw = dict(
        family="binomial", alpha=0.5, nlambda=5, batch_size=32, seed=2,
        hybrid=True, hybrid_max_head=32, hybrid_coverage=0.8, standardize=False,
    )
    ref = st.fit(sp.csr_matrix(x), y, dtype=np.float32, **kw)
    q8 = st.fit(sp.csr_matrix(x), y, dtype=np.float32, hybrid_head_dtype="int8", **kw)
    # the data is exact; the residual difference is the bf16 cast of w
    # inside the int8 matmul (~1e-4 measured) — an indexing/scale bug would
    # be orders of magnitude larger
    np.testing.assert_allclose(q8.beta, ref.beta, atol=5e-4)
    np.testing.assert_allclose(q8.a0, ref.a0, atol=5e-4)


def test_int8_quantize_head_roundtrip():
    """quantize_head: dequantized values within scale/2 of the original;
    matvec_T / matmul_dense agree with the dequantized dense operator."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    x = rng.normal(size=(64, 40)) * (1 + 4 * rng.random(40))
    x[np.abs(x) < 0.7] = 0.0
    xh, _ = HybridCSR.split_columns(sp.csr_matrix(x), coverage=0.7, max_head=16)
    q = xh.quantize_head()
    assert q.head.dtype == jnp.int8
    deq = np.asarray(q.head).astype(np.float64) * np.asarray(q.head_scale)
    err = np.abs(deq - np.asarray(xh.head))
    assert (err <= np.asarray(q.head_scale) / 2 + 1e-12).all()

    dense_q = deq.copy()
    tail_dense = np.asarray(xh.tail.to_dense())
    full_q = tail_dense.copy()
    full_q[:, : q.n_head] += dense_q
    # bf16 rounding of v inside the head matmul gives ~0.4% of the SUM OF
    # MAGNITUDES, which cancellation can amplify relative to the result —
    # compare with an absolute tolerance on the result scale
    v = rng.normal(size=(64, 3))
    want = full_q.T @ v
    np.testing.assert_allclose(
        np.asarray(q.matvec_T(jnp.asarray(v, jnp.float32))), want,
        atol=2e-2 * np.abs(want).max(),
    )
    wt = rng.normal(size=(xh.n_cols, 2))
    want2 = full_q @ wt
    np.testing.assert_allclose(
        np.asarray(q.matmul_dense(jnp.asarray(wt, jnp.float32))), want2,
        atol=2e-2 * np.abs(want2).max(),
    )


def test_int8_host_std_quant_matches_device_order():
    """The host-side fused standardize+quantize ingestion (round 4:
    split_columns(std_stats=...) — only int8 bytes ever reach the device)
    must produce element-for-element the same layout as the device order
    (build f32 head -> standardize -> quantize_head): same int8 codes (to
    one rounding LSB), same scales, same scale-only tail."""
    import jax.numpy as jnp

    from sgdnet_tpu.core.sparse import scipy_column_stats

    rng = np.random.default_rng(9)
    n, p = 120, 48
    x = rng.normal(size=(n, p)) * (rng.random((n, p)) < 0.3)
    x[:, 0] = rng.normal(size=n)  # one fully-dense column (no implicit zeros)
    xs = sp.csr_matrix(x)
    mean, sd = scipy_column_stats(xs)
    np.testing.assert_allclose(mean, x.mean(axis=0), atol=1e-12)

    kw = dict(coverage=0.8, max_head=16)
    host, perm_h = HybridCSR.split_columns(
        xs, head_dtype=jnp.int8, std_stats=(mean, sd), **kw
    )
    f32, perm_d = HybridCSR.split_columns(xs, dtype=jnp.float32, **kw)
    np.testing.assert_array_equal(perm_h, perm_d)
    m_dev = jnp.asarray(mean[perm_d])
    s_dev = jnp.asarray(sd[perm_d])
    dev, xc = f32.standardize(m_dev, s_dev)
    dev = dev.quantize_head()

    np.testing.assert_allclose(
        np.asarray(host.head_scale), np.asarray(dev.head_scale), rtol=1e-5
    )
    # int8 codes agree to <= 1 LSB (f64 host vs f32 device rounding ties)
    dq = np.abs(
        np.asarray(host.head, np.int32) - np.asarray(dev.head, np.int32)
    )
    assert dq.max() <= 1
    assert (dq > 0).mean() < 0.01  # ties are rare
    np.testing.assert_allclose(
        np.asarray(host.tail.values), np.asarray(dev.tail.values), rtol=1e-5
    )
    # the host path's tail centering correction matches standardize()'s xc
    xc_host = (mean[perm_h] / sd[perm_h]).copy()
    xc_host[: host.n_head] = 0.0
    np.testing.assert_allclose(xc_host, np.asarray(xc), rtol=1e-5)


def test_int8_host_vs_device_path_fit_agrees():
    """fit() through the host int8 ingestion (scipy input) agrees with the
    device order (prebuilt f32 hybrid standardized+quantized on device) at
    the solver contract, on an identical lambda grid."""
    xs, y = _sparse_problem(n=400, p=64, family="binomial", seed=29)
    kw = dict(
        family="binomial", alpha=0.5, batch_size=32, seed=7, dtype=np.float32,
        hybrid_head_dtype="int8",
    )
    host = st.fit(xs, y, nlambda=6, hybrid=True, hybrid_max_head=32,
                  hybrid_coverage=0.8, **kw)
    assert host.stats["layout"]["kind"] == "hybrid"
    assert host.stats["layout"]["head_dtype"] == "int8"
    import jax.numpy as jnp

    xh, perm = HybridCSR.split_columns(xs, coverage=0.8, max_head=32, dtype=jnp.float32)
    dev = st.fit(xh, y, lambda_path=host.lambda_, **kw)
    beta_dev = np.empty_like(dev.beta)
    beta_dev[:, :, perm] = dev.beta  # prebuilt layouts return permuted columns
    scale = max(np.abs(host.beta).max(), 1.0)
    # the two paths round from f64 vs f32 intermediates, so ~1% of int8
    # codes differ by one LSB (see the layout-level test): they solve two
    # quantized problems one quantization tie apart.  The agreement bound
    # is therefore between solver precision and the int8-vs-f32 contract
    # (4e-2 in test_int8_head_close_to_f32); measured max ~6e-3 relative.
    np.testing.assert_allclose(host.beta, beta_dev, atol=1e-2 * scale)
