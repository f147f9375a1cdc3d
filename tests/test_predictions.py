"""Prediction-type tests (reference tests/testthat/test-predictions.R)."""

import numpy as np
import pytest

import sgdnet_tpu as st
from sgdnet_tpu.api.predict import lambda_interpolate
from tests.helpers import random_data


@pytest.fixture(scope="module")
def gaussian_fit():
    x, y = random_data(n=150, p=5, seed=1)
    return st.fit(x, y, nlambda=10, dtype=np.float64), x, y


def test_lambda_interpolation_endpoints(gaussian_fit):
    fit, x, y = gaussian_fit
    # s equal to a path point reproduces that point exactly
    for i in [0, 4, 9]:
        left, right, frac = lambda_interpolate(fit.lambda_, fit.lambda_[i])
        beta_i = fit.beta[left[0], 0] * frac[0] + fit.beta[right[0], 0] * (1 - frac[0])
        np.testing.assert_allclose(beta_i, fit.beta[i, 0], atol=1e-12)


def test_interpolated_prediction_between_points(gaussian_fit):
    fit, x, y = gaussian_fit
    s_mid = np.sqrt(fit.lambda_[3] * fit.lambda_[4])  # between points 3 and 4
    pred = fit.predict(x, s=s_mid)
    p3 = fit.predict(x, s=fit.lambda_[3])
    p4 = fit.predict(x, s=fit.lambda_[4])
    lo, hi = np.minimum(p3, p4), np.maximum(p3, p4)
    assert np.all(pred >= lo - 1e-9) and np.all(pred <= hi + 1e-9)


def test_s_clamped_to_path_range(gaussian_fit):
    fit, x, y = gaussian_fit
    hi = fit.predict(x, s=fit.lambda_[0] * 10)
    np.testing.assert_allclose(hi, fit.predict(x, s=fit.lambda_[0]), atol=1e-12)
    lo = fit.predict(x, s=fit.lambda_[-1] / 10)
    np.testing.assert_allclose(lo, fit.predict(x, s=fit.lambda_[-1]), atol=1e-12)


def test_coefficients_and_nonzero_types(gaussian_fit):
    fit, x, y = gaussian_fit
    coefs = fit.coef()
    assert coefs.shape == (10, 6)  # intercept + 5 features
    np.testing.assert_allclose(coefs[:, 0], fit.a0)
    nz = fit.predict(type="nonzero")
    assert len(nz) == 10
    assert len(nz[0]) == 0  # fully sparse at lambda_max (lasso path)
    assert len(nz[-1]) > 0


def test_exact_refit(gaussian_fit):
    """exact=True refits with the requested lambda added to the path
    (reference R/predict.sgdnet.R:180-188, test-predictions.R)."""
    fit, x, y = gaussian_fit
    s = np.sqrt(fit.lambda_[3] * fit.lambda_[4])
    approx = fit.predict(x, s=s)
    exact = fit.predict(x, s=s, exact=True, x=x, y=y, thresh=1e-7)
    # different but close; and the exact one matches a direct fit at s
    direct = st.fit(x, y, lambda_path=[s], thresh=1e-7, dtype=np.float64).predict(x)
    np.testing.assert_allclose(exact, direct, atol=1e-4)
    assert np.abs(approx - exact).max() < 0.1


def test_negative_s_rejected(gaussian_fit):
    fit, x, y = gaussian_fit
    with pytest.raises(ValueError, match="cannot be negative"):
        fit.predict(x, s=-1.0)


def test_newx_required(gaussian_fit):
    fit, x, y = gaussian_fit
    with pytest.raises(ValueError, match="newx"):
        fit.predict(type="link")


def test_multinomial_prediction_shapes():
    x, y = random_data(n=120, p=4, family="multinomial", n_classes=3, seed=2)
    fit = st.fit(x, y, family="multinomial", nlambda=6, dtype=np.float64)
    assert fit.predict(x, type="link").shape == (120, 3, 6)
    assert fit.predict(x, type="response").shape == (120, 3, 6)
    assert fit.predict(x, type="class").shape == (120, 6)
    coefs = fit.coef()
    assert coefs.shape == (6, 3, 5)
    nz = fit.predict(type="nonzero")
    assert set(nz.keys()) == set(fit.classnames)


def test_deviance_method(gaussian_fit):
    """(reference R/deviance.sgdnet.R:33-35, test-deviance.R)"""
    fit, x, y = gaussian_fit
    dev = fit.deviance()
    np.testing.assert_allclose(dev, (1 - fit.dev_ratio) * fit.nulldev)
    assert np.all(np.diff(dev) <= 1e-8)  # deviance decreases along path


def test_na_propagation(gaussian_fit):
    """NaN rows in newx propagate to NaN predictions, and class predictions
    on NaN logits are NaN (reference test-predictions.R:109-125)."""
    fit, x, y = gaussian_fit
    newx = x[:5].copy()
    newx[2, :] = np.nan
    pred = fit.predict(newx)
    assert np.isnan(pred[2]).all() and np.isfinite(pred[0]).all()

    xb, yb = random_data(n=120, p=6, family="binomial", seed=33)
    fb = st.fit(xb, yb, family="binomial", nlambda=5)
    nb = xb[:4].copy()
    nb[1, 0] = np.nan
    cls = fb.predict(nb, type="class")
    assert cls.dtype == object
    flat = cls[1] if cls.ndim == 1 else cls[1, :]
    assert all(isinstance(c, float) and np.isnan(c) for c in np.atleast_1d(flat))
    ok = cls[0] if cls.ndim == 1 else cls[0, :]
    assert all(isinstance(c, str) for c in np.atleast_1d(ok))


def test_padded_csr_newx_no_densify():
    """predict accepts PaddedCSR / HybridCSR newx directly (device matmul,
    never densified) and matches the dense prediction."""
    import scipy.sparse as sp

    from sgdnet_tpu.core.sparse import PaddedCSR

    x, y = random_data(n=150, p=12, family="gaussian", density=0.3, seed=34)
    fit = st.fit(x, y, nlambda=6, dtype=np.float64)
    dense_pred = fit.predict(x)
    csr = PaddedCSR.from_scipy(sp.csr_matrix(x), dtype=np.float64)
    padded_pred = fit.predict(csr)
    np.testing.assert_allclose(padded_pred, dense_pred, rtol=1e-8)


def test_refit_args_carry_layout_options():
    """predict(exact=True) refits with the original layout/perf options
    (round-1 VERDICT: layout kwargs were dropped)."""
    x, y = random_data(n=130, p=9, family="gaussian", seed=35)
    fit = st.fit(x, y, nlambda=6, dtype=np.float64, sampling="permutation",
                 g_sum_refresh_every=3, sparse_mode="densify")
    args = fit._refit_args
    assert args["g_sum_refresh_every"] == 3
    assert args["sampling"] == "permutation"
    assert args["sparse_mode"] == "densify"
    assert "hybrid" in args and "mesh" in args and "hybrid_head_dtype" in args
    # the refit replays exactly fit()'s options: nothing fit() does not take
    import inspect

    assert set(args) <= set(inspect.signature(st.fit).parameters)
