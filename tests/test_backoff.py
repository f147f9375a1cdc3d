"""In-program step-size oscillation recovery (SolverConfig.step_backoff).

Pins the failure shape seen on the accelerator at bench scale —
mid-path lambdas where the expected-smoothness step is too large hit
max_iter with final_change far above tol (or diverge outright) — and the
round-5 recovery: fit_path retries a suspicious lambda in-program with the
step halved, keeping the retry only when it wins, so the DEFAULT
single-dispatch path converges with no user-visible knob (VERDICT r4 #3).

CPU repro: a correlated (effectively rank-8) design with the step inflated
well past the expected-smoothness bound oscillates/diverges mid-path once
the active set densifies — the same shape as the chip measurement at
lambda[24..31] of the bench path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sgdnet_tpu.families import get_family
from sgdnet_tpu.penalties import select_penalty
from sgdnet_tpu.solver.saga import SolverConfig, fit_path, init_state
from sgdnet_tpu.solver.stepsize import power_iteration_sq_norm, saga_step_sizes


@pytest.fixture(scope="module")
def osc_problem():
    rng = np.random.default_rng(3)
    n, p = 256, 120
    z = rng.normal(size=(n, 8))
    mix = rng.normal(size=(8, p))
    x = z @ mix + 0.05 * rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:6] = [3, -2, 1.5, -1, 2, -1.5]
    y = x @ beta + 0.1 * rng.normal(size=n)

    dtype = jnp.float64
    xm, xs = x.mean(0), x.std(0)
    xs[xs == 0] = 1
    x_std = jnp.asarray((x - xm) / xs, dtype)
    y_proc = jnp.asarray(((y - y.mean()) / y.std()).reshape(-1, 1), dtype)
    weights = jnp.ones((n,), dtype)
    fam = get_family("gaussian")
    pen = select_penalty(1.0, "gaussian")
    lmax = float(np.abs(x_std.T @ y_proc[:, 0]).max()) / n
    l1s = jnp.asarray(np.geomspace(lmax, lmax * 1e-3, 8), dtype)
    l2s = jnp.zeros_like(l1s)
    max_sq = float(jnp.max(jnp.sum(x_std**2, axis=1)))
    top_sq = power_iteration_sq_norm(x_std, None) / n * 1.2
    g0 = saga_step_sizes(max_sq, top_sq, l2s, float(n), 32, True, 1.0).astype(dtype)
    return x_std, y_proc, weights, fam, pen, l1s, l2s, g0


def _run(prob, gmul, backoff):
    x_std, y_proc, weights, fam, pen, l1s, l2s, g0 = prob
    n, p = x_std.shape
    cfg = SolverConfig(batch_size=32, max_iter=300, fit_intercept=True, step_backoff=backoff)
    s0 = init_state(n, p, 1, jnp.float64)
    s0 = s0._replace(intercept=fam.null_intercept(y_proc, True, weights).astype(jnp.float64))
    _, n_iter, res = fit_path(
        x_std, y_proc, weights, None, g0 * gmul, l1s, l2s,
        jnp.asarray(1e-4, jnp.float64), jax.random.PRNGKey(0), s0, fam, pen, cfg,
    )
    return jax.device_get((n_iter, res))


def test_oscillation_reported_honestly_without_backoff(osc_problem):
    """With the step inflated past stability and no backoff, mid-path
    lambdas must land as code 1 with final_change = inf — NOT as code 0 on
    a non-finite solution (the convergence check once accepted inf <= inf)."""
    _, res = _run(osc_problem, 16.0, backoff=False)
    codes = np.asarray(res.return_codes)
    rel = np.asarray(res.final_change)
    bad = codes == 1
    assert bad.any(), "repro lost: inflated step no longer oscillates"
    # every suspicious exit is visible to the detector: far above tol or inf
    assert (rel[bad] > 10 * 1e-4).all()
    # no lambda may report convergence on a non-finite solution
    w = np.asarray(res.w)
    ok = codes == 0
    assert np.isfinite(w[ok]).all()


def test_default_path_recovers_in_program(osc_problem):
    """The DEFAULT path (step_backoff=True) converges every lambda and
    matches a cleanly-stepped oracle at the coefficient contract."""
    _, res_oracle = _run(osc_problem, 4.0, backoff=False)
    assert (np.asarray(res_oracle.return_codes) == 0).all()

    n_iter, res = _run(osc_problem, 16.0, backoff=True)
    codes = np.asarray(res.return_codes)
    assert (codes == 0).all(), f"backoff failed to recover: {codes}"
    w = np.asarray(res.w)
    w_o = np.asarray(res_oracle.w)
    scale = max(1.0, float(np.abs(w_o).max()))
    np.testing.assert_allclose(w, w_o, atol=2e-3 * scale)
    # all attempts count toward npasses: recovery costs epochs, bounded by
    # 3 * max_iter per lambda
    assert int(n_iter) <= 3 * 300 * len(codes)


def test_divergence_never_poisons_warm_starts(osc_problem):
    """Even when attempts diverge, the carried warm-start state stays
    finite (a nan state would poison every deeper lambda)."""
    x_std, y_proc, weights, fam, pen, l1s, l2s, g0 = osc_problem
    n, p = x_std.shape
    cfg = SolverConfig(batch_size=32, max_iter=60, fit_intercept=True, step_backoff=True)
    s0 = init_state(n, p, 1, jnp.float64)
    s0 = s0._replace(intercept=fam.null_intercept(y_proc, True, weights).astype(jnp.float64))
    # hopelessly inflated: attempts at x64/x32/x16 the stable step all fail
    st, _, res = fit_path(
        x_std, y_proc, weights, None, g0 * 64.0, l1s, l2s,
        jnp.asarray(1e-4, jnp.float64), jax.random.PRNGKey(0), s0, fam, pen, cfg,
    )
    st, res = jax.device_get((st, res))
    for leaf in st:
        assert np.isfinite(np.asarray(leaf)).all()
    # reported coefficients for non-recovered lambdas are the finite
    # fallback, never inf/nan
    assert np.isfinite(np.asarray(res.w)).all()


def test_fit_step_backoff_kwarg():
    """Public-API pass-through: on a path with no suspicious exits the
    backoff machinery must be a bit-exact no-op (attempt 0 reuses the
    unmodified lambda key), so fit(step_backoff=False) == the default."""
    import sgdnet_tpu as st

    rng = np.random.default_rng(7)
    x = rng.normal(size=(80, 10))
    y = x[:, 0] - x[:, 1] + 0.1 * rng.normal(size=80)
    f_on = st.fit(x, y, nlambda=6, dtype=np.float64)
    f_off = st.fit(x, y, nlambda=6, dtype=np.float64, step_backoff=False)
    assert (f_on.return_codes == 0).all()
    np.testing.assert_array_equal(f_on.beta, f_off.beta)
    np.testing.assert_array_equal(f_on.a0, f_off.a0)
