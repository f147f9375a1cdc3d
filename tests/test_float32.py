"""float32 solver-path tests — the default dtype on the GPU.

The f64 suites verify exact semantics against oracles; these verify that
the f32 path (with per-epoch exact g_sum refresh to kill accumulation
drift, solver/saga.py) still meets the 1e-3 coefficient contract.
"""

import numpy as np

import sgdnet_tpu as st
from tests.helpers import random_data


def test_gaussian_f32_matches_f64():
    x, y = random_data(n=300, p=8, seed=1)
    f64 = st.fit(x, y, nlambda=10, thresh=1e-5, dtype=np.float64)
    f32 = st.fit(x, y, lambda_path=f64.lambda_, thresh=1e-5, dtype=np.float32)
    scale = max(1.0, np.abs(f64.beta).max())
    np.testing.assert_allclose(f32.beta, f64.beta, atol=2e-3 * scale)
    np.testing.assert_allclose(f32.a0, f64.a0, atol=5e-3 * scale)


def test_binomial_f32_matches_f64():
    x, y = random_data(n=300, p=6, family="binomial", seed=2)
    f64 = st.fit(x, y, family="binomial", nlambda=8, thresh=1e-5, dtype=np.float64)
    f32 = st.fit(x, y, family="binomial", lambda_path=f64.lambda_, thresh=1e-5, dtype=np.float32)
    scale = max(1.0, np.abs(f64.beta).max())
    np.testing.assert_allclose(f32.beta, f64.beta, atol=3e-3 * scale)


def test_abalone_f32():
    from sgdnet_tpu.data import load_abalone

    x, y = load_abalone()
    f32 = st.fit(x, y, alpha=0.8, nlambda=20)
    f64 = st.fit(x, y, alpha=0.8, nlambda=20, dtype=np.float64)
    np.testing.assert_allclose(f32.dev_ratio, f64.dev_ratio, atol=2e-3)
    scale = max(1.0, np.abs(f64.beta).max())
    np.testing.assert_allclose(f32.beta, f64.beta, atol=5e-3 * scale)
