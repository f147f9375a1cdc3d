"""bf16 and int8 hybrid heads under block sampling, for every family.

Block sampling is the path the reduced-precision heads run on at scale
(contiguous row blocks, packed BlockCOO tail).  Each case fits the same
sparse problem with an f32 head and with the reduced head on the same
lambda path and holds them to the loosened contracts of
tests/test_perf_modes.py: ~2e-2*scale for bf16 (values rounded to 8
mantissa bits) and ~4e-2*scale for int8 (per-column quantization to 1/254
of the column's largest value).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import sgdnet_tpu as st
from tests.helpers import random_data

TOL = {"bfloat16": 2e-2, "int8": 4e-2}
FAMILIES = ["gaussian", "binomial", "poisson", "multinomial", "mgaussian"]


def _problem(family, n=400, p=200):
    if family == "poisson":
        rng = np.random.default_rng(31)
        x = rng.normal(size=(n, p)) * (rng.random((n, p)) < 0.3)
        y = rng.poisson(np.exp(0.2 + x @ (rng.normal(size=p) * 0.05))).astype(np.float64)
    else:
        x, y = random_data(n=n, p=p, family=family, density=0.3, seed=29)
    return sp.csr_matrix(x), y


@pytest.mark.parametrize("head", list(TOL))
@pytest.mark.parametrize("family", FAMILIES)
def test_reduced_head_block_sampling_close_to_f32(family, head):
    xs, y = _problem(family)
    kw = dict(
        family=family, alpha=0.5, batch_size=32, seed=7, sampling="block",
        hybrid=True, hybrid_max_head=32, hybrid_coverage=0.8, dtype=np.float32,
    )
    ref = st.fit(xs, y, nlambda=6, **kw)
    red = st.fit(xs, y, lambda_path=ref.lambda_, hybrid_head_dtype=head, **kw)
    assert red.stats["layout"]["head_dtype"] == head
    assert red.stats["layout"]["blk_tail"] and ref.stats["layout"]["blk_tail"]
    scale = max(np.abs(ref.beta).max(), 1.0)
    assert np.max(np.abs(red.beta - ref.beta)) <= TOL[head] * scale
    a0_scale = max(np.abs(np.asarray(ref.a0)).max(), 1.0)
    assert np.max(np.abs(np.asarray(red.a0) - np.asarray(ref.a0))) <= TOL[head] * a0_scale


@pytest.mark.parametrize("rows", [50, 64, 200])
def test_int8_products_match_float64(rows, monkeypatch):
    """The int8 head products run in float32 at full precision, block by
    block over rows (here 64-row blocks, so 200 rows take three blocks and
    a remainder): they match float64 products of the same values."""
    import jax.numpy as jnp

    import sgdnet_tpu.core.sparse as sparse

    monkeypatch.setattr(sparse, "INT8_ROW_BLOCK", 64)
    rng = np.random.default_rng(rows)
    q = rng.integers(-127, 128, size=(rows, 30))
    b = rng.normal(size=(30, 2))
    a = rng.normal(size=(rows, 3))
    qj = jnp.asarray(q, jnp.int8)
    got = np.asarray(sparse.int8_matmul(qj, jnp.asarray(b, jnp.float32)))
    np.testing.assert_allclose(got, q @ b.astype(np.float32), rtol=1e-5, atol=1e-4)
    got_t = np.asarray(sparse.int8_tmatmul(jnp.asarray(a, jnp.float32), qj))
    np.testing.assert_allclose(got_t, a.astype(np.float32).T @ q, rtol=1e-5, atol=1e-3)
