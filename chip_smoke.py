"""Smoke run of the lambda-path fit on the GPU, through the public API.

    python chip_smoke.py              # one GPU: every single-device phase
    python chip_smoke.py --four-gpus  # four GPUs: the sharded fit and the
                                      # fold-parallel CV, nothing else

Phases, each of which checks its own results and raises on a failure:

  device     the platform must be "gpu"; the card's name and power limit
             come from nvidia-smi, run in a child process that stays off JAX
  bundled    st.fit on abalone (gaussian, alpha 0.8), heart (binomial), wine
             (multinomial) and student (mgaussian), 20 lambdas, float32 on
             the GPU, against the same fits in float64 on the CPU backend
  cv         st.cv_fit(nfolds=5, parallel=True) on heart against CPU float64
  head_step  XLA's hybrid-head step (forward + outer product) at bf16
             D=16384 and int8 D=32768, B=8192, against the one-pass bound
  planner    the two constants of the layout planner (core/layout.py)
  latency    per-step time of the abalone 20-lambda path
  main_path  the rcv1-shaped sparse binomial (n=100k, p=47k, 76 nnz/row)
             through st.fit with the int8 hybrid head, the first 10 lambdas
             of its 50-lambda path, run twice; float64 KKT residuals on the
             host; the first 2 lambdas against CPU float64

The float64 references run in a child process on the CPU backend
(JAX_PLATFORMS=cpu, x64 on); this process is the only one on the card.
Every timing ends in `block_until_ready` or a host copy of the result.
The phase functions take their sizes as arguments, so the CPU tests run
them small.  The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from bench import gpu_info, make_sparse_binomial, require_gpu, to_scipy

# Published device-memory bandwidth by JAX device_kind (NVIDIA data
# sheets); the one-pass bound of the head step divides by it.  A card that
# is not listed is an error, not a default.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM
}

#: bundled dataset -> (family, extra fit arguments)
BUNDLED = {
    "abalone": ("gaussian", {"alpha": 0.8}),
    "heart": ("binomial", {}),
    "wine": ("multinomial", {}),
    "student": ("mgaussian", {}),
}

#: contract tolerances (CLAUDE.md invariants): lambda path relative, and
#: coefficients / predictions relative to max(1, max |reference|)
LAMBDA_RTOL = 1e-5
COEF_TOL = 1e-3

#: relative-change tolerance of the bundled fits.  At the default 1e-3 the
#: float32 and float64 trajectories stop up to ~1.1e-3*scale apart (wine);
#: at 1e-4 they agree to ~3e-4*scale (CPU backend, both dtypes)
BUNDLED_THRESH = 1e-4

#: the main path's fit options: the bench's int8 hybrid head, run to
#: thresh 1e-4 like the bundled fits — at fit()'s default 1e-3 the H100 run
#: stopped 1.01e-3*scale from the float64 reference on the second lambda
#: (NVIDIA H100 80GB HBM3, 400 W)
MAIN_FIT = dict(
    family="binomial", batch_size=8192, sampling="block", g_sum_refresh_every=8, thresh=1e-4,
    hybrid=True, hybrid_max_head=32768, hybrid_coverage=0.995, hybrid_head_dtype="int8",
    hybrid_memory_budget=8e9,  # fit()'s 2e9 default would cap the head at D~20k
)


def log(*a):
    print(*a, flush=True)


def scale_of(a) -> float:
    return max(1.0, float(np.max(np.abs(a))))


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# float64 CPU references (run in a child process by the GPU run)
# ---------------------------------------------------------------------------


def reference_results(jobs: list[dict]) -> dict:
    """Run each job on the current default backend in float64; returns a
    flat dict of numpy arrays keyed '<job name>/<field>'."""
    import sgdnet_tpu as st
    from sgdnet_tpu.data.datasets import load_dataset

    out = {}
    for job in jobs:
        t0 = time.perf_counter()
        name, kind = job["name"], job["kind"]
        if kind == "bundled":
            family, kw = BUNDLED[job["dataset"]]
            d = load_dataset(job["dataset"])
            f = st.fit(d["x"], d["y"], family=family, dtype=np.float64, **kw, **job["fit"])
            out[f"{name}/lambda"] = f.lambda_
            out[f"{name}/beta"] = f.beta
            out[f"{name}/a0"] = np.asarray(f.a0)
            out[f"{name}/pred"] = np.asarray(f.predict(d["x"], type="response"))
        elif kind == "cv":
            family, kw = BUNDLED[job["dataset"]]
            d = load_dataset(job["dataset"])
            cv = st.cv_fit(d["x"], d["y"], family=family, dtype=np.float64, **kw, **job["fit"])
            out[f"{name}/lambda"] = np.asarray(cv.lambda_[0])
            out[f"{name}/lambda_min"] = np.asarray(cv.lambda_min)
            out[f"{name}/lambda_1se"] = np.asarray(cv.lambda_1se)
        elif kind == "sparse":
            data = dict(job["data"])
            quantize = data.pop("quantize", None)
            X, y = sparse_problem(**data)
            if quantize is not None:
                X = quantized_design(X, quantize)[0]
            f = st.fit(X, y, dtype=np.float64, lambda_path=np.asarray(job["lambda_"]), **job["fit"])
            out[f"{name}/beta"] = f.beta
            out[f"{name}/a0"] = np.asarray(f.a0)
            out[f"{name}/return_codes"] = f.return_codes
        else:
            raise ValueError(f"unknown reference job kind {kind!r}")
        out[f"{name}/seconds"] = np.asarray(time.perf_counter() - t0)
    return out


class CpuReference:
    """The float64 references, computed by a child process on the CPU
    backend while this process keeps the GPU busy.  Use it as a context
    manager: leaving the block stops the child if it still runs."""

    def __init__(self, jobs: list[dict]):
        self._dir = tempfile.TemporaryDirectory()
        job_file = os.path.join(self._dir.name, "jobs.json")
        self._out = os.path.join(self._dir.name, "ref.npz")
        with open(job_file, "w") as fh:
            json.dump(jobs, fh)
        env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--reference", job_file, self._out],
            env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
        )

    def result(self) -> dict:
        rc = self._proc.wait()
        if rc != 0:
            raise RuntimeError(f"CPU float64 reference process failed (exit {rc})")
        with np.load(self._out) as z:
            res = {k: z[k] for k in z.files}
        log(f"[reference] CPU float64 child finished after "
            f"{time.perf_counter() - self._t0:.3f} s")
        return res

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._dir.cleanup()


class InProcessReference:
    """Same interface as CpuReference, computed in this process (CPU tests)."""

    def __init__(self, jobs: list[dict]):
        self._res = reference_results(jobs)

    def result(self) -> dict:
        return self._res

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


# ---------------------------------------------------------------------------
# bundled datasets and CV
# ---------------------------------------------------------------------------


def bundled_jobs(names=tuple(BUNDLED), nlambda: int = 20, thresh: float = BUNDLED_THRESH,
                 maxit: int = 10_000) -> list[dict]:
    return [
        dict(name=f"bundled_{nm}", kind="bundled", dataset=nm,
             fit=dict(nlambda=nlambda, thresh=thresh, maxit=maxit))
        for nm in names
    ]


def cv_jobs(dataset: str = "heart", nfolds: int = 5, nlambda: int = 20, seed: int = 0,
            thresh: float = BUNDLED_THRESH) -> list[dict]:
    return [dict(name=f"cv_{dataset}", kind="cv", dataset=dataset,
                 fit=dict(nfolds=nfolds, nlambda=nlambda, seed=seed, parallel=True,
                          thresh=thresh, maxit=10_000))]


def bundled_fits(jobs: list[dict], ref: dict) -> dict:
    """float32 fits on the default device against the float64 reference:
    lambda path within LAMBDA_RTOL, coefficients and response predictions
    within COEF_TOL * scale."""
    import sgdnet_tpu as st
    from sgdnet_tpu.data.datasets import load_dataset

    out = {}
    for job in jobs:
        name = job["name"]
        family, kw = BUNDLED[job["dataset"]]
        d = load_dataset(job["dataset"])
        t0 = time.perf_counter()
        f = st.fit(d["x"], d["y"], family=family, dtype=np.float32, **kw, **job["fit"])
        wall = time.perf_counter() - t0
        pred = np.asarray(f.predict(d["x"], type="response"))
        lam_err = float(np.max(np.abs(f.lambda_ / ref[f"{name}/lambda"] - 1.0)))
        rb = ref[f"{name}/beta"]
        coef_err = float(np.max(np.abs(f.beta - rb))) / scale_of(rb)
        a0_err = float(np.max(np.abs(np.asarray(f.a0) - ref[f"{name}/a0"]))) / scale_of(ref[f"{name}/a0"])
        rp = ref[f"{name}/pred"]
        pred_err = float(np.max(np.abs(pred - rp))) / scale_of(rp)
        log(f"[bundled] {job['dataset']:8s} {family:11s} wall {wall:.3f} s (compile included), "
            f"epochs {f.npasses}, codes {int(np.sum(f.return_codes))} unconverged; "
            f"lambda rel {lam_err:.3e}, coef {coef_err:.3e}*scale, "
            f"intercept {a0_err:.3e}*scale, predict {pred_err:.3e}*scale")
        check(lam_err <= LAMBDA_RTOL, f"{name}: lambda path off by {lam_err:.3e} relative")
        check(coef_err <= COEF_TOL, f"{name}: coefficients off by {coef_err:.3e}*scale")
        check(a0_err <= COEF_TOL, f"{name}: intercepts off by {a0_err:.3e}*scale")
        check(pred_err <= COEF_TOL, f"{name}: predictions off by {pred_err:.3e}*scale")
        check(np.all(np.isfinite(f.beta)), f"{name}: non-finite coefficients")
        out[name] = dict(lambda_rel=lam_err, coef=coef_err, a0=a0_err, pred=pred_err,
                         epochs=int(f.npasses), wall_s=wall)
    return out


def cv_check(jobs: list[dict], ref: dict) -> dict:
    """cv_fit in float32 on the default device: lambda_min and lambda_1se
    finite and at the same lambda as the float64 reference."""
    import sgdnet_tpu as st
    from sgdnet_tpu.data.datasets import load_dataset

    out = {}
    for job in jobs:
        name = job["name"]
        family, kw = BUNDLED[job["dataset"]]
        d = load_dataset(job["dataset"])
        t0 = time.perf_counter()
        cv = st.cv_fit(d["x"], d["y"], family=family, dtype=np.float32, **kw, **job["fit"])
        wall = time.perf_counter() - t0
        lam, rlam = np.asarray(cv.lambda_[0]), ref[f"{name}/lambda"]
        res = {}
        for key in ("lambda_min", "lambda_1se"):
            got, want = float(getattr(cv, key)), float(ref[f"{name}/{key}"])
            check(np.isfinite(got), f"{name}: {key} is not finite")
            i_got = int(np.argmin(np.abs(lam - got)))
            i_want = int(np.argmin(np.abs(rlam - want)))
            check(i_got == i_want, f"{name}: {key} at lambda index {i_got}, reference {i_want}")
            check(abs(got / want - 1.0) <= LAMBDA_RTOL, f"{name}: {key} {got} vs reference {want}")
            res[key] = (got, i_got)
        log(f"[cv] {job['dataset']} nfolds={job['fit']['nfolds']} parallel: wall {wall:.3f} s; "
            f"lambda_min {res['lambda_min'][0]:.6g} (index {res['lambda_min'][1]}), "
            f"lambda_1se {res['lambda_1se'][0]:.6g} (index {res['lambda_1se'][1]}), "
            f"both equal to the CPU float64 result")
        out[name] = res
    return out


def path_step_time(dataset: str = "abalone", nlambda: int = 20) -> dict:
    """Warm wall of a bundled path fit divided by its SAGA steps: the
    small-problem latency regime (ROADMAP Queue 1 #5)."""
    import sgdnet_tpu as st
    from sgdnet_tpu.data.datasets import load_dataset

    family, kw = BUNDLED[dataset]
    d = load_dataset(dataset)
    st.fit(d["x"], d["y"], family=family, nlambda=nlambda, **kw)  # compile
    t0 = time.perf_counter()
    f = st.fit(d["x"], d["y"], family=family, nlambda=nlambda, **kw)
    wall = time.perf_counter() - t0
    bs = f._refit_args["batch_size"]
    steps = f.npasses * (-(-f.nobs // bs))
    log(f"[latency] {dataset} {nlambda}-lambda path, B={bs}: warm wall {wall:.4f} s, "
        f"in-path {f.stats['wall_time_s']:.4f} s, {f.npasses} epochs = {steps} steps, "
        f"{f.stats['wall_time_s'] / steps * 1e6:.2f} us per step (in-path)")
    return dict(wall_s=wall, path_s=f.stats["wall_time_s"], steps=int(steps),
                us_per_step=f.stats["wall_time_s"] / steps * 1e6)


# ---------------------------------------------------------------------------
# head step and planner constants
# ---------------------------------------------------------------------------


def _time_dispatch(fn, *args, reps: int = 3) -> float:
    """Best-of-`reps` wall of fn(*args) after a warm-up call; each timing
    ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def head_step(head_dtype: str, width: int, batch: int = 8192, blocks: int = 8,
              steps: int = 64, peak_bytes_per_s: float | None = None) -> dict:
    """Device time per step of the solver's hybrid-head step (forward
    matmul, gradient, gradient-memory update, outer matmul; an empty tail)
    as XLA compiles it, over `blocks` distinct row blocks so no block is
    cache-resident.  The bound is one pass over the (batch, width) block:
    batch * width * itemsize / peak bandwidth."""
    import jax
    import jax.numpy as jnp

    from sgdnet_tpu.core.sparse import HybridCSR, PaddedCSR
    from sgdnet_tpu.families import get_family
    from sgdnet_tpu.solver.saga import _batch_outer, _batch_predict, _rows, _set_rows

    n = blocks * batch
    key = jax.random.PRNGKey(0)
    if head_dtype == "int8":
        head = jax.random.randint(key, (n, width), -127, 128, jnp.int8)
        head_scale = jnp.full((width,), 0.01, jnp.float32)
    else:
        head = jax.random.normal(key, (n, width), jnp.float32).astype(jnp.dtype(head_dtype))
        head_scale = None
    tail = PaddedCSR(jnp.zeros((n, 8), jnp.int32), jnp.zeros((n, 8), jnp.float32),
                     jnp.zeros((n,), jnp.int32), n, width)
    x = HybridCSR(head, tail, n, width, head_scale=head_scale)
    y = (jax.random.uniform(jax.random.fold_in(key, 1), (n, 1)) < 0.5).astype(jnp.float32)
    fam = get_family("binomial")

    @jax.jit
    def run(x, y, w, g_mem):
        with jax.default_matmul_precision("highest"):
            def body(carry, i):
                w, g_mem = carry
                sel = (i % blocks) * batch
                lp = _batch_predict(x, None, w, sel, batch)
                g = fam.gradient(lp, _rows(y, sel, batch))
                g_change = g - _rows(g_mem, sel, batch)
                g_mem = _set_rows(g_mem, sel, g, batch)
                corr = _batch_outer(x, None, g_change, sel, batch, "gather")
                return (w - 1e-6 * corr, g_mem), None

            return jax.lax.scan(body, (w, g_mem), jnp.arange(steps))[0]

    w0 = jnp.zeros((1, width), jnp.float32)
    g0 = jnp.zeros((n, 1), jnp.float32)
    t = _time_dispatch(run, x, y, w0, g0) / steps
    itemsize = jnp.dtype(head.dtype).itemsize
    one_pass = batch * width * itemsize
    res = dict(dtype=head_dtype, width=width, batch=batch, step_s=t,
               stream_bytes_per_s=2 * one_pass / t)
    msg = (f"[head_step] {head_dtype} D={width} B={batch}: {t * 1e6:.2f} us per step, "
           f"two-pass stream {2 * one_pass / t / 1e9:.1f} GB/s")
    if peak_bytes_per_s is not None:
        bound = one_pass / peak_bytes_per_s
        res.update(bound_s=bound, over_bound=t / bound)
        msg += (f"; one-pass bound {bound * 1e6:.2f} us "
                f"({one_pass / 1e6:.0f} MB at {peak_bytes_per_s / 1e12:.2f} TB/s), "
                f"{t / bound:.2f}x the bound")
    log(msg)
    check(np.isfinite(t) and t > 0, "head step time is not positive")
    del x, head
    return res


def tail_element_cost(entries: int = 1 << 18, batch: int = 8192, n_cols: int = 47_000,
                      blocks: int = 8, steps: int = 64, seed: int = 0) -> dict:
    """Device time per element-op of the packed BlockCOO tail as the solver
    runs it: forward gather + scatter and outer gather + scatter
    (core/layout.py TAIL_OPS_PER_ENTRY = 4) over `entries` nonzeros per
    block, with Zipf column popularity like the rcv1-shaped data."""
    import jax
    import jax.numpy as jnp

    from sgdnet_tpu.core.layout import TAIL_OPS_PER_ENTRY
    from sgdnet_tpu.core.sparse import BlockCOO
    from sgdnet_tpu.solver.saga import _coo_batch_outer, _coo_batch_predict

    rng = np.random.default_rng(seed)
    wts = (np.arange(n_cols) + 10.0) ** -1.15
    cdf = np.cumsum(wts) / wts.sum()
    cols = np.searchsorted(cdf, rng.random((blocks, entries))).clip(0, n_cols - 1)
    rows = rng.integers(0, batch, size=(blocks, entries))
    bt = BlockCOO(jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
                  jnp.asarray(rng.normal(size=(blocks, entries)), jnp.float32), batch, n_cols)

    @jax.jit
    def run(bt, w):
        def body(w, i):
            blk = i % blocks
            lp = _coo_batch_predict(bt, w, blk, batch)
            return w - 1e-6 * _coo_batch_outer(bt, lp, blk), None

        return jax.lax.scan(body, w, jnp.arange(steps))[0]

    t = _time_dispatch(run, bt, jnp.zeros((1, n_cols), jnp.float32)) / steps
    per_elem = t / (TAIL_OPS_PER_ENTRY * entries)
    log(f"[planner] BlockCOO tail, {entries} entries per block of {batch} rows: "
        f"{t * 1e6:.2f} us per step, {per_elem * 1e9:.4f} ns per element-op")
    check(np.isfinite(per_elem) and per_elem > 0, "tail element cost is not positive")
    return dict(entries=entries, step_s=t, elem_op_s=per_elem)


# ---------------------------------------------------------------------------
# main path: the rcv1-shaped sparse binomial
# ---------------------------------------------------------------------------


def sparse_problem(n: int, p: int, nnz_per_row: int, seed: int = 0):
    """The bench's rcv1-shaped sparse binomial as (scipy CSR, y)."""
    data, y = make_sparse_binomial(n, p, nnz_per_row, seed=seed)
    return to_scipy(data), y.ravel()


def first_lambdas_ratio(n_fit: int, nlambda: int, lambda_min_ratio: float) -> float:
    """lambda_min_ratio under which fit(nlambda=n_fit) generates exactly
    the first n_fit lambdas of its nlambda-long log-spaced path."""
    return lambda_min_ratio ** ((n_fit - 1) / (nlambda - 1))


def kkt_residuals(X, y, beta, a0, lambdas, mean, sd, alpha: float = 1.0):
    """float64 KKT residuals of binomial elastic-net fits on the host, on
    the design (X - mean) / sd that fit() solves: for each lambda the
    largest violation of  g_j + lam (1-alpha) w_j + lam alpha sign(w_j) = 0
    (w_j != 0)  or  |g_j| <= lam alpha  (w_j = 0), with w = beta * sd and g
    the gradient of the mean loss; one sparse product X^T r per lambda.
    `beta` and `a0` are on the scale of X (eta = a0 + X beta).  Returns the
    residuals divided by lam * alpha."""
    n = X.shape[0]
    XT = X.T.tocsr()
    out = []
    for l, lam in enumerate(lambdas):
        w = beta[l, 0] * sd
        r = 1.0 / (1.0 + np.exp(-(X @ beta[l, 0] + a0[l]))) - y
        g = (XT @ r - mean * r.sum()) / (n * sd)
        viol = np.where(
            w != 0,
            np.abs(g + lam * (1 - alpha) * w + lam * alpha * np.sign(w)),
            np.maximum(np.abs(g) - lam * alpha, 0.0),
        )
        out.append(float(viol.max()) / (lam * alpha))
    return np.asarray(out)


def quantized_design(X, fit_kw: dict):
    """The problem an int8 hybrid fit of X solves, as a float64 scipy CSR
    in the original column order: standardized tail columns, and head
    columns dequantized minus their implicit-zero level.  fit() quantizes
    the standardized head per column (core/sparse.py split_columns), so its
    design is this matrix plus a constant per column, which only shifts
    the intercept.  Returns (S, mean, sd, zero_level): fitting S with
    standardize=False gives w = beta * sd of the int8 fit, and intercept
    a_S = a0 + sum_j zero_level_j * w_j."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from sgdnet_tpu.core.sparse import HybridCSR, scipy_column_stats

    mean, sd = scipy_column_stats(X)
    xh, perm = HybridCSR.split_columns(
        X, coverage=fit_kw["hybrid_coverage"], max_head=fit_kw["hybrid_max_head"],
        memory_budget=fit_kw["hybrid_memory_budget"], head_dtype=jnp.int8,
        std_stats=(mean, sd), as_host=True, head_form="nnz", dtype=jnp.float64,
    )
    hn, d, t = xh.head, xh.n_head, xh.tail
    scale = np.asarray(xh.head_scale, np.float64)  # the float32 scales fit() uses
    q0 = hn.q0.astype(np.float64)
    t_mask = np.arange(t.row_width)[None, :] < t.nnz[:, None]
    rows = np.concatenate([hn.rows, np.nonzero(t_mask)[0]])
    cols = perm[np.concatenate([hn.cols, t.indices[t_mask]])]
    vals = np.concatenate([scale[hn.cols] * (hn.vals - q0[hn.cols]), t.values[t_mask]])
    S = sp.csr_matrix((vals, (rows, cols)), shape=X.shape)
    zero_level = np.zeros(X.shape[1])
    zero_level[perm[:d]] = scale * q0 + (mean / sd)[perm[:d]]
    return S, mean, sd, zero_level


#: bound on the KKT residual / (lambda * alpha) of the main path on the
#: design it solves: the stop rule bounds the relative change of w per
#: epoch, not the gradient; at thresh 1e-3 the H100 run stayed below 0.026
#: on the first 10 lambdas (NVIDIA H100 80GB HBM3, 400 W)
KKT_BOUND = 0.05


def main_path(n: int = 100_000, p: int = 47_000, nnz_per_row: int = 76, n_fit: int = 10,
              nlambda: int = 50, n_ref: int = 2, seed: int = 0, fit_kw: dict | None = None,
              reference=CpuReference) -> dict:
    """The main path at full width, through st.fit: the first n_fit
    lambdas of the nlambda path (n >= p, so lambda_min_ratio 1e-4), fitted
    twice; float64 KKT residuals; the first n_ref lambdas against float64
    on the CPU."""
    import jax

    import sgdnet_tpu as st

    kw = dict(MAIN_FIT if fit_kw is None else fit_kw)
    t0 = time.perf_counter()
    X, y = sparse_problem(n, p, nnz_per_row, seed)
    log(f"[main_path] data: n={n} p={p} nnz={X.nnz} built on the host in "
        f"{time.perf_counter() - t0:.3f} s")
    ratio = first_lambdas_ratio(n_fit, nlambda, 1e-4 if n >= p else 1e-2)

    t0 = time.perf_counter()
    cold = st.fit(X, y, nlambda=n_fit, lambda_min_ratio=ratio, **kw)
    t_cold = time.perf_counter() - t0
    lam = cold.lambda_
    t0 = time.perf_counter()
    warm = st.fit(X, y, lambda_path=lam, **kw)
    t_warm = time.perf_counter() - t0
    dev = jax.devices()[0]
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    spread = float(np.max(np.abs(warm.beta - cold.beta)))
    log(f"[main_path] layout {warm.stats['layout']}")
    log(f"[main_path] cold wall {t_cold:.3f} s (ingestion + compile + path), "
        f"warm wall {t_warm:.3f} s (in-path {warm.stats['wall_time_s']:.3f} s)")
    log(f"[main_path] epochs {cold.npasses} / {warm.npasses}, return codes {warm.return_codes.tolist()}")
    log(f"[main_path] peak_bytes_in_use {peak}")
    log(f"[main_path] run-to-run max |beta diff| {spread:.3e} "
        f"(max |beta| {np.max(np.abs(warm.beta)):.3e})")

    t0 = time.perf_counter()
    S, mean, sd, zero_level = quantized_design(X, kw)
    a_S = np.asarray(warm.a0) + warm.beta[:, 0] @ (zero_level * sd)
    kkt = kkt_residuals(S, y, warm.beta * sd, a_S, lam, 0.0, 1.0)
    kkt_exact = kkt_residuals(X, y, warm.beta, np.asarray(warm.a0), lam, mean, sd)
    log(f"[main_path] float64 KKT residual / (lambda*alpha), {time.perf_counter() - t0:.3f} s "
        f"on the host; on the int8 design the fit solves (bound {KKT_BOUND}): "
        f"{np.array2string(kkt, precision=4)}; on the unquantized data: "
        f"{np.array2string(kkt_exact, precision=4)}")
    check(np.all(np.isfinite(warm.beta)), "main path: non-finite coefficients")
    check(bool(np.all(kkt <= KKT_BOUND)), f"main path: KKT residual above {KKT_BOUND}")

    ref_kw = {k: v for k, v in kw.items() if not k.startswith("hybrid")}
    job = dict(name="main", kind="sparse", lambda_=lam[:n_ref].tolist(),
               data=dict(n=n, p=p, nnz_per_row=nnz_per_row, seed=seed, quantize=kw),
               fit=dict(ref_kw, hybrid=False, standardize=False, thresh=1e-6, maxit=100_000))
    t0 = time.perf_counter()
    with reference([job]) as r:
        ref = r.result()
    t_ref = time.perf_counter() - t0
    w_ref = ref["main/beta"]  # standardized scale: beta_ref = w / sd
    rb = w_ref / sd
    ra0 = ref["main/a0"] - w_ref[:, 0] @ zero_level
    coef_err = float(np.max(np.abs(warm.beta[:n_ref] - rb))) / scale_of(rb)
    a0_err = float(np.max(np.abs(np.asarray(warm.a0)[:n_ref] - ra0))) / scale_of(ra0)
    log(f"[main_path] CPU float64 reference (the same int8 design, PaddedCSR, thresh 1e-6) "
        f"for the first {n_ref} lambdas took {t_ref:.3f} s "
        f"({float(ref['main/seconds']):.3f} s in the child); coef {coef_err:.3e}*scale, "
        f"intercept {a0_err:.3e}*scale (contract {COEF_TOL})")
    check(coef_err <= COEF_TOL, f"main path: coefficients off by {coef_err:.3e}*scale")
    check(a0_err <= COEF_TOL, f"main path: intercepts off by {a0_err:.3e}*scale")
    return dict(cold_s=t_cold, warm_s=t_warm, epochs=int(warm.npasses),
                codes=warm.return_codes.tolist(), peak_bytes=peak, spread=spread,
                kkt=kkt.tolist(), kkt_exact=kkt_exact.tolist(), ref_s=t_ref, coef=coef_err, a0=a0_err)


# ---------------------------------------------------------------------------
# four devices
# ---------------------------------------------------------------------------

#: sharded vs single-device intercepts: on sparse data the intercept steps
#: at intercept_decay=0.01 of the coefficient step (the reference's quirk)
#: and the stopping rule watches w only, so each run stops with its
#: intercept short of the optimum by a different amount; the same bound as
#: tests/test_parallel.py (5e-3*scale)
SHARDED_A0_TOL = 5e-3
#: fold-parallel vs serial CV curves: the fold-parallel fits run as masked
#: full-data fits with their own step sizes, so fold scores differ at the
#: stopping tolerance (tests/test_parallel.py allows 5% per fold score)
CV_CURVE_TOL = 1e-2


def sharded_fit(n_dev: int = 4, n: int = 100_000, p: int = 47_000, nnz_per_row: int = 76,
                n_fit: int = 10, nlambda: int = 50, seed: int = 0, thresh: float = 1e-5,
                fit_kw: dict | None = None) -> dict:
    """The main-path config row-sharded over make_mesh(n_dev), against one
    device at the same global batch, within COEF_TOL * scale.  The two
    draw different batches, so both run to a tight `thresh`: at the
    default 1e-3 each stops up to ~1e-2*scale from the optimum."""
    import sgdnet_tpu as st
    from sgdnet_tpu.parallel.dist import make_mesh

    kw = dict(MAIN_FIT if fit_kw is None else fit_kw)
    kw.pop("thresh", None)
    global_batch = kw.pop("batch_size")
    X, y = sparse_problem(n, p, nnz_per_row, seed)
    ratio = first_lambdas_ratio(n_fit, nlambda, 1e-4 if n >= p else 1e-2)
    t0 = time.perf_counter()
    single = st.fit(X, y, nlambda=n_fit, lambda_min_ratio=ratio, batch_size=global_batch,
                    thresh=thresh, **kw)
    t_single = time.perf_counter() - t0
    mesh = make_mesh(n_dev)
    t0 = time.perf_counter()
    shard = st.fit(X, y, lambda_path=single.lambda_, mesh=mesh, batch_size=global_batch // n_dev,
                   thresh=thresh, **kw)
    t_shard = time.perf_counter() - t0

    g_mem = shard.final_state.g_mem
    placement = sorted((str(s.device), tuple(s.data.shape)) for s in g_mem.addressable_shards)
    log(f"[four] gradient-memory shards: {placement}")
    devices = {d for d, _ in placement}
    check(len(devices) == n_dev, f"rows landed on {len(devices)} devices, not {n_dev}")
    check(all(s[0] == g_mem.shape[0] // n_dev for _, s in placement),
          "row shards are not equal slices of the rows")
    err = float(np.max(np.abs(shard.beta - single.beta))) / scale_of(single.beta)
    a0_err = float(np.max(np.abs(np.asarray(shard.a0) - np.asarray(single.a0)))) / scale_of(single.a0)
    log(f"[four] sharded over {n_dev} devices (B={global_batch // n_dev} each) vs one device "
        f"(B={global_batch}): coef {err:.3e}*scale, intercept {a0_err:.3e}*scale; "
        f"walls {t_shard:.3f} s vs {t_single:.3f} s (compile included); "
        f"epochs {shard.npasses} vs {single.npasses}")
    check(err <= COEF_TOL, f"sharded fit off by {err:.3e}*scale")
    check(a0_err <= SHARDED_A0_TOL, f"sharded intercepts off by {a0_err:.3e}*scale")
    return dict(coef=err, a0=a0_err, placement=placement)


def fold_parallel_cv(n_dev: int = 4, dataset: str = "heart", nfolds: int = 5,
                     nlambda: int = 20, seed: int = 0, thresh: float = 1e-5) -> dict:
    """cv_fit with the folds sharded over make_mesh(n_dev, axis="folds"),
    against the serial CV on one device: same lambda_min and lambda_1se,
    CV curves within CV_CURVE_TOL * scale."""
    import sgdnet_tpu as st
    from sgdnet_tpu.data.datasets import load_dataset
    from sgdnet_tpu.parallel.dist import make_mesh

    family, kw = BUNDLED[dataset]
    d = load_dataset(dataset)
    common = dict(family=family, nfolds=nfolds, nlambda=nlambda, seed=seed, thresh=thresh,
                  maxit=100_000, **kw)
    serial = st.cv_fit(d["x"], d["y"], **common)
    par = st.cv_fit(d["x"], d["y"], parallel=True, cv_mesh=make_mesh(n_dev, axis="folds"), **common)
    m_s = np.asarray(serial.cv_summary["mean"])
    m_p = np.asarray(par.cv_summary["mean"])
    err = float(np.max(np.abs(m_p - m_s))) / scale_of(m_s)
    log(f"[four] fold-parallel CV over {n_dev} devices vs serial: CV mean {err:.3e}*scale; "
        f"lambda_min {par.lambda_min:.6g} vs {serial.lambda_min:.6g}, "
        f"lambda_1se {par.lambda_1se:.6g} vs {serial.lambda_1se:.6g}")
    check(par.lambda_min == serial.lambda_min, "fold-parallel lambda_min differs from serial")
    check(par.lambda_1se == serial.lambda_1se, "fold-parallel lambda_1se differs from serial")
    check(err <= CV_CURVE_TOL, f"fold-parallel CV curve off by {err:.3e}*scale")
    return dict(cv_mean=err)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def log_memory(phase: str):
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    log(f"[memory] after {phase}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}, "
        f"bytes_in_use {stats.get('bytes_in_use')}")


def run_one_gpu(kind: str):
    import jax

    peak = PEAK_BYTES_PER_S.get(kind)
    if peak is None:
        raise RuntimeError(f"no published bandwidth for device kind {kind!r}")
    b_jobs, c_jobs = bundled_jobs(), cv_jobs()
    with CpuReference(b_jobs + c_jobs) as ref:  # runs while the GPU phases below do
        head_step("bfloat16", 16384, peak_bytes_per_s=peak)
        int8 = head_step("int8", 32768, peak_bytes_per_s=peak)
        tail = tail_element_cost()
        log(f"[planner] STREAM_BYTES_PER_S = {int8['stream_bytes_per_s']:.4g}, "
            f"ELEM_OP_S = {tail['elem_op_s']:.4g}")
        log_memory("head_step and planner")
        refs = ref.result()

    bundled_fits(b_jobs, refs)
    cv_check(c_jobs, refs)
    path_step_time("abalone")
    log_memory("bundled, cv and latency")
    jax.clear_caches()
    main_path()


def run_four_gpus(count: int):
    if count < 4:
        raise RuntimeError(f"--four-gpus needs 4 GPUs, JAX sees {count}")
    sharded_fit(4)
    fold_parallel_cv(4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-device phases (sharded fit, fold-parallel CV)")
    ap.add_argument("--reference", nargs=2, metavar=("JOBS", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.reference:  # child: float64 references on the CPU backend
        with open(args.reference[0]) as fh:
            jobs = json.load(fh)
        np.savez(args.reference[1], **reference_results(jobs))
        return

    platform, kind, count = require_gpu()
    cards = gpu_info()
    for name, limit in cards:
        log(f"[device] {name}, {limit}")
    log(f"[device] JAX: platform {platform}, device_kind {kind!r}, count {count}; "
        f"compile cache {__import__('jax').config.jax_compilation_cache_dir}")
    t0 = time.perf_counter()
    if args.four_gpus:
        run_four_gpus(count)
    else:
        run_one_gpu(kind)
    name, limit = cards[0]
    log(f"[done] all phases passed in {time.perf_counter() - t0:.3f} s on {name}, {limit}")
    print(json.dumps({"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
