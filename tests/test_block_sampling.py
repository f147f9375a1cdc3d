"""The XLA block-sampling path on dense float32 inputs — the small-problem
path of `fit()` — against the float64 path.

Block sampling draws contiguous row blocks in a seeded random order, and
the float32 and float64 fits below share seed and sampling, so they take
the same blocks in the same order: they differ by rounding, and by the
epoch at which each meets the stopping rule.  Every case holds them to the
1e-3*scale coefficient contract.
"""

import numpy as np
import pytest

import sgdnet_tpu as st
from sgdnet_tpu.data.datasets import load_dataset


def _bundled(name):
    d = load_dataset(name)
    return d["x"], d["y"]


def _poisson():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 6))
    y = rng.poisson(np.exp(0.3 + x @ (rng.normal(size=6) * 0.3))).astype(np.float64)
    return x, y


def _extra(name, n, p):
    """Per-case arguments that depend on the data's shape."""
    rng = np.random.default_rng(1)
    pf = np.ones(p)
    pf[0], pf[min(3, p - 1)] = 0.0, 4.0
    return {
        "weights": dict(sample_weight=rng.uniform(0.2, 2.0, size=n)),
        "offsets_binomial": dict(offset=rng.normal(size=n) * 0.3),
        "offsets_gaussian": dict(offset=rng.normal(size=n) * 0.2),
        "penalty_factors": dict(penalty_factor=pf),
        "offsets_and_pf": dict(offset=rng.normal(size=n) * 0.2, penalty_factor=pf),
    }.get(name, {})


CASES = {
    "gaussian": ("abalone", dict(family="gaussian", alpha=0.8)),
    "binomial": ("heart", dict(family="binomial", alpha=0.8)),
    "multinomial": ("wine", dict(family="multinomial", alpha=0.8)),
    "mgaussian": ("student", dict(family="mgaussian", alpha=0.8)),
    "poisson": ("poisson", dict(family="poisson", alpha=0.5)),
    "ridge": ("abalone", dict(family="gaussian", alpha=0.0)),
    "no_intercept": ("abalone", dict(family="gaussian", alpha=1.0, intercept=False)),
    "raw_scale": ("abalone", dict(family="gaussian", alpha=0.5, standardize=False)),
    "grouped_multinomial": ("wine", dict(family="multinomial", alpha=0.9, type_multinomial="grouped")),
    "weights": ("heart", dict(family="binomial", alpha=0.7)),
    "refresh_cadence": ("abalone", dict(family="gaussian", alpha=0.8, g_sum_refresh_every=4)),
    "offsets_binomial": ("heart", dict(family="binomial", alpha=0.6)),
    "offsets_gaussian": ("abalone", dict(family="gaussian", alpha=0.8)),
    "penalty_factors": ("abalone", dict(family="gaussian", alpha=1.0)),
    "offsets_and_pf": ("heart", dict(family="binomial", alpha=0.5)),
}


def _pair(x, y, **kw):
    common = dict(nlambda=8, sampling="block", seed=3, **kw)
    f64 = st.fit(x, y, dtype=np.float64, **common)
    f32 = st.fit(x, y, dtype=np.float32, lambda_path=f64.lambda_,
                 **{k: v for k, v in common.items() if k != "nlambda"})
    return f32, f64


def _assert_contract(f32, f64, tol=1e-3):
    scale = max(1.0, np.abs(f64.beta).max())
    assert np.abs(f32.beta - f64.beta).max() <= tol * scale
    a0_scale = max(1.0, np.abs(np.asarray(f64.a0)).max())
    assert np.abs(np.asarray(f32.a0) - np.asarray(f64.a0)).max() <= tol * a0_scale
    assert np.abs(f32.dev_ratio - f64.dev_ratio).max() <= tol


@pytest.mark.parametrize("case", list(CASES))
def test_block_f32_matches_f64(case):
    data, kw = CASES[case]
    x, y = _poisson() if data == "poisson" else _bundled(data)
    f32, f64 = _pair(x, y, **kw, **_extra(case, *x.shape))
    assert f32._refit_args["sampling"] == "block"
    _assert_contract(f32, f64)
    if case in ("penalty_factors", "offsets_and_pf"):
        # the unpenalized feature is active from the first lambda on
        assert np.abs(f32.beta[0, :, 0]).max() > 0


def test_block_warm_refit_matches_path():
    """predict(exact=True) refits from the fit's warm state (permutation
    sampling, the warm_state default) and must reproduce the block-sampled
    fit at a lambda on its path."""
    x, y = _bundled("abalone")
    f = st.fit(x, y, family="gaussian", nlambda=6, dtype=np.float32, sampling="block")
    lam = float(f.lambda_[2])
    exact = np.asarray(f.predict(x[:5], s=lam, exact=True, x=x, y=y))
    interp = np.asarray(f.predict(x[:5], s=lam))
    assert np.abs(exact - interp).max() <= 1e-3 * max(1.0, np.abs(interp).max())
