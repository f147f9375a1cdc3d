"""chip_smoke.py and bench.py on the CPU: the phase functions at tiny
sizes, the device check, the nvidia-smi parser, the compile-cache choice,
and the KKT residual.  The phases compare a float32 fit on the default
device with a float64 reference; here both run on the CPU backend (the
reference in process), on the GPU the reference runs in a CPU child."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import bench
import chip_smoke as cs
import sgdnet_tpu as st
from sgdnet_tpu.core.sparse import scipy_column_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the main-path options cut to a tiny problem (same int8 hybrid head,
#: block sampling, BlockCOO tail)
TINY_MAIN = dict(cs.MAIN_FIT, batch_size=256, hybrid_max_head=128, hybrid_coverage=0.9)


@pytest.mark.parametrize(
    "text, want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n", [("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("NVIDIA H100 80GB HBM3, 500.00 W\n" * 4, [("NVIDIA H100 80GB HBM3", "500.00 W")] * 4),
        ("Name, with comma, 350.00 W\n\n", [("Name, with comma", "350.00 W")]),
    ],
)
def test_parse_gpu_info(text, want):
    assert bench.parse_gpu_info(text) == want


def test_parse_gpu_info_rejects_empty():
    with pytest.raises(ValueError):
        bench.parse_gpu_info("\n")


def test_require_gpu_raises_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.require_gpu()


def test_smoke_main_fails_without_gpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_four_gpu_phase_needs_four_devices():
    with pytest.raises(RuntimeError, match="needs 4 GPUs"):
        cs.run_four_gpus(1)


def test_smoke_script_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("env, want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}, "/some/cache"),
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir_choice(env, want):
    assert st.compile_cache_dir(env) == want


_COMPILE = ("import jax, jax.numpy as jnp, sgdnet_tpu; "
            "print(jax.config.jax_compilation_cache_dir); "
            "jax.jit(lambda a: jnp.cos(a) * {k})(jnp.ones(8)).block_until_ready()")


def _compile_in_child(env, k):
    env = dict(env, JAX_PLATFORMS="cpu", JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    r = subprocess.run([sys.executable, "-c", _COMPILE.format(k=k)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300, check=True)
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_in_repo_when_unset():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    before = set(os.listdir(st.REPO_CACHE_DIR)) if os.path.isdir(st.REPO_CACHE_DIR) else set()
    # a constant of its own (pid) so the entry is new even when the cache is warm
    assert _compile_in_child(env, os.getpid()) == st.REPO_CACHE_DIR
    assert set(os.listdir(st.REPO_CACHE_DIR)) - before


def test_compile_cache_files_land_in_the_variable_dir(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert _compile_in_child(env, 2) == str(tmp_path)
    assert any(tmp_path.iterdir())


def test_first_lambdas_ratio_cuts_the_generated_path():
    x, y = bench.make_sparse_binomial(n=600, p=300, nnz_per_row=8, seed=2)
    X, y = bench.to_scipy(x), y.ravel()
    kw = dict(family="binomial", maxit=1, thresh=1e30, step_backoff=False, hybrid=False)
    full = st.fit(X, y, nlambda=50, **kw)
    head = st.fit(X, y, nlambda=6, lambda_min_ratio=cs.first_lambdas_ratio(6, 50, 1e-4), **kw)
    np.testing.assert_allclose(head.lambda_, full.lambda_[:6], rtol=1e-12)


def _binomial_sparse():
    x, y = bench.make_sparse_binomial(n=800, p=200, nnz_per_row=12, seed=4)
    return bench.to_scipy(x).astype(np.float64), y.ravel().astype(np.float64)


def _tight_fit():
    X, y = _binomial_sparse()
    f = st.fit(X, y, family="binomial", nlambda=4, lambda_min_ratio=0.2, thresh=1e-7,
               maxit=20000, hybrid=False, dtype=np.float64)
    return X, y, f, *scipy_column_stats(X)


def test_kkt_residual_small_at_the_optimum():
    X, y, f, mean, sd = _tight_fit()
    kkt = cs.kkt_residuals(X, y, f.beta, np.asarray(f.a0), f.lambda_, mean, sd)
    assert np.all(kkt < 1e-3)


def test_kkt_residual_flags_a_wrong_solution():
    X, y, f, mean, sd = _tight_fit()
    beta = f.beta.copy()
    beta[-1, 0, np.argmax(np.abs(beta[-1, 0]))] *= 1.5
    kkt = cs.kkt_residuals(X, y, beta, np.asarray(f.a0), f.lambda_, mean, sd)
    assert kkt[-1] > 0.1


def test_quantized_design_reproduces_the_int8_fit():
    """Fitting the int8 design with standardize=False (the main path's
    float64 reference) lands on the int8 fit's coefficients."""
    X, y = _binomial_sparse()
    kw = dict(TINY_MAIN, batch_size=64, hybrid_max_head=128, thresh=1e-7)
    f = st.fit(X, y, nlambda=3, lambda_min_ratio=0.3, maxit=50000, **kw)
    S, mean, sd, zero_level = cs.quantized_design(X, kw)
    ref_kw = {k: v for k, v in kw.items() if not k.startswith("hybrid")}
    r = st.fit(S, y, lambda_path=f.lambda_, standardize=False, hybrid=False,
               maxit=50000, dtype=np.float64, **dict(ref_kw, thresh=1e-9))
    rb = r.beta / sd
    assert np.abs(f.beta - rb).max() <= 1e-3 * max(1.0, np.abs(rb).max())
    ra0 = r.a0 - r.beta[:, 0] @ zero_level
    assert np.abs(np.asarray(f.a0) - ra0).max() <= 1e-3 * max(1.0, np.abs(ra0).max())


@pytest.mark.parametrize("name", list(cs.BUNDLED))
def test_bundled_phase_tiny(name):
    jobs = cs.bundled_jobs(names=(name,), nlambda=5)
    res = cs.bundled_fits(jobs, cs.InProcessReference(jobs).result())
    assert res[f"bundled_{name}"]["coef"] <= cs.COEF_TOL


def test_cv_phase_tiny():
    jobs = cs.cv_jobs(nfolds=3, nlambda=6)
    res = cs.cv_check(jobs, cs.InProcessReference(jobs).result())
    assert np.isfinite(res["cv_heart"]["lambda_min"][0])


def test_cpu_reference_child_process():
    """The reference jobs run in a CPU child through the --reference entry
    point and come back intact."""
    jobs = cs.bundled_jobs(names=("heart",), nlambda=3)
    with cs.CpuReference(jobs) as ref:
        got = ref.result()
    want = cs.InProcessReference(jobs).result()
    np.testing.assert_allclose(got["bundled_heart/lambda"], want["bundled_heart/lambda"])
    np.testing.assert_allclose(got["bundled_heart/beta"], want["bundled_heart/beta"], atol=1e-12)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_head_step_tiny(dtype):
    r = cs.head_step(dtype, 256, batch=64, blocks=2, steps=3, peak_bytes_per_s=1e12)
    assert r["step_s"] > 0 and r["over_bound"] > 0


def test_tail_element_cost_tiny():
    r = cs.tail_element_cost(entries=512, batch=64, n_cols=300, blocks=2, steps=3)
    assert r["elem_op_s"] > 0


def test_path_step_time_tiny():
    r = cs.path_step_time("heart", nlambda=3)
    assert r["steps"] > 0 and r["us_per_step"] > 0


def test_main_path_tiny():
    r = cs.main_path(n=3000, p=600, nnz_per_row=12, n_fit=4, nlambda=50, fit_kw=TINY_MAIN,
                     reference=cs.InProcessReference)
    assert r["coef"] <= cs.COEF_TOL and len(r["kkt"]) == 4


def test_sharded_fit_tiny():
    r = cs.sharded_fit(n_dev=4, n=2048, p=400, nnz_per_row=10, n_fit=3, nlambda=20,
                       fit_kw=TINY_MAIN)
    assert len({d for d, _ in r["placement"]}) == 4


def test_fold_parallel_cv_tiny():
    r = cs.fold_parallel_cv(n_dev=4, nfolds=5, nlambda=20)
    assert r["cv_mean"] <= cs.CV_CURVE_TOL


def test_canonical_csr_sums_duplicates():
    """Duplicate entries of a non-canonical CSR are summed before any
    layout is built (the int8 head scatter promises unique indices)."""
    from sgdnet_tpu.core.sparse import canonical_csr

    X = sp.csr_matrix((np.array([1.0, 2.0, 3.0]), np.array([0, 0, 1]), np.array([0, 3])),
                      shape=(1, 2))
    assert not X.has_canonical_format
    Xc = canonical_csr(X)
    assert Xc.has_canonical_format and not X.has_canonical_format
    np.testing.assert_array_equal(Xc.toarray(), [[3.0, 3.0]])


@pytest.mark.gpu
def test_phases_on_the_gpu(gpu_env):
    """The card-only check: the head step, the tail cost and one bundled
    fit (against the float64 CPU child) at small sizes, on the GPU."""
    code = "\n".join([
        "import chip_smoke as cs",
        "cs.require_gpu()",
        "cs.head_step('int8', 1024, batch=256, blocks=2, steps=4, peak_bytes_per_s=3.35e12)",
        "cs.tail_element_cost(entries=4096, batch=256, n_cols=2000, blocks=2, steps=4)",
        "jobs = cs.bundled_jobs(names=('heart',), nlambda=5)",
        "with cs.CpuReference(jobs) as ref:",
        "    cs.bundled_fits(jobs, ref.result())",
    ])
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=gpu_env, check=True, timeout=900)
