"""Model-fitting front end.

Accelerator equivalent of the reference's R orchestration layer + C++ setup
(reference R/sgdnet.R:183-433 and src/sgdnet.cpp:119-285): input validation,
response encoding, feature standardization, lambda-path construction, solver
dispatch, and output assembly into an `SgdnetFit`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from sgdnet_tpu.core.sparse import HybridCSR, PaddedCSR
from sgdnet_tpu.families import get_family
from sgdnet_tpu.penalties import select_penalty
from sgdnet_tpu.solver.saga import SagaState, SolverConfig, fit_path, init_state
from sgdnet_tpu.solver.stepsize import power_iteration_sq_norm, saga_step_sizes

FAMILIES = ("gaussian", "binomial", "poisson", "multinomial", "mgaussian")


@dataclass
class SgdnetFit:
    """Fitted regularization path (reference fit object, R/sgdnet.R:131-156).

    Coefficients are stored as `beta` with shape (n_lambda, k, p) on the
    original data scale; `a0` is (n_lambda, k).
    """

    a0: np.ndarray
    beta: np.ndarray
    lambda_: np.ndarray
    dev_ratio: np.ndarray
    df: np.ndarray
    dfmat: np.ndarray | None
    nulldev: float
    npasses: int
    return_codes: np.ndarray
    alpha: float
    family: str
    classnames: list | None
    grouped: bool
    nobs: int
    offset: bool = False
    feature_names: list | None = None
    diagnostics: dict | None = None
    #: everything needed to refit (predict(..., exact=True))
    _refit_args: dict | None = field(default=None, repr=False)
    #: final solver state — pass as `warm_state=` to resume, or serialize
    #: with utils.checkpoint.save_state
    final_state: object = field(default=None, repr=False)
    #: throughput counters: wall_time_s, nnz (design-matrix nonzeros),
    #: nnz_per_s (north-star metric, BASELINE.md), epochs
    stats: dict | None = field(default=None, repr=False)

    @property
    def n_lambda(self) -> int:
        return len(self.lambda_)

    @property
    def n_classes(self) -> int:
        return self.beta.shape[1]

    @property
    def n_features(self) -> int:
        return self.beta.shape[2]

    def predict(self, newx=None, s=None, type="link", exact=False, **kwargs):
        from sgdnet_tpu.api.predict import predict

        return predict(self, newx=newx, s=s, type=type, exact=exact, **kwargs)

    def coef(self, s=None, **kwargs):
        from sgdnet_tpu.api.predict import predict

        return predict(self, s=s, type="coefficients", **kwargs)

    def deviance(self):
        """Deviance along the path: (1 - dev_ratio) * nulldev
        (reference R/deviance.sgdnet.R:33-35)."""
        return (1.0 - self.dev_ratio) * self.nulldev

    def score(self, x, y, type_measure="deviance", s=None, offset=None):
        from sgdnet_tpu.api.score import score

        return score(self, x, y, type_measure=type_measure, s=s, offset=offset)

    def plot(self, **kwargs):
        from sgdnet_tpu.api.plot import plot_path

        return plot_path(self, **kwargs)

    def __repr__(self):
        return (
            f"SgdnetFit(family={self.family!r}, alpha={self.alpha}, "
            f"n_lambda={self.n_lambda}, nobs={self.nobs}, "
            f"n_features={self.n_features}, npasses={self.npasses})"
        )

    def print_path(self, max_rows: int = 100):
        """Path summary table (reference R/print.sgdnet.R:38-45)."""
        lines = ["     Df   %Dev   Lambda"]
        for i in range(min(self.n_lambda, max_rows)):
            lines.append(f"{i:>3} {int(self.df[i]):>4} {self.dev_ratio[i]:6.2f} {self.lambda_[i]:>9.4g}")
        return "\n".join(lines)


def _as_design_matrix(
    x, dtype, hybrid=None, hybrid_coverage=0.9, hybrid_max_head=16384,
    hybrid_memory_budget=2e9, hybrid_head_dtype=None,
):
    """Accept numpy/jax dense, scipy sparse, PaddedCSR, or HybridCSR.

    scipy input with many columns is converted to the dense-head/sparse-tail
    HybridCSR layout (see core/sparse.py) with a column permutation; returns
    (x, is_sparse, col_perm, nan_checked) where col_perm maps new -> original
    columns and nan_checked marks inputs already NaN-validated host-side
    (no device round trip is needed for them).
    """
    if isinstance(x, (PaddedCSR, HybridCSR)):
        return x, True, None, False
    try:
        import scipy.sparse as sp

        if sp.issparse(x):
            if np.isnan(x.tocsr().data).any():
                raise ValueError("NA values are not allowed.")
            p = x.shape[1]
            if hybrid is None:
                hybrid = p > 512
            if hybrid:
                xh, perm = HybridCSR.split_columns(
                    x,
                    coverage=hybrid_coverage,
                    max_head=hybrid_max_head,
                    dtype=dtype,
                    memory_budget=hybrid_memory_budget,
                    head_dtype=hybrid_head_dtype,
                )
                return xh, True, perm, True
            return PaddedCSR.from_scipy(x, dtype=dtype), True, None, True
    except ImportError:
        pass
    x_np = np.asarray(x)
    if x_np.ndim != 2:
        raise ValueError("x must be a 2-D matrix")
    if x_np.dtype != object and np.issubdtype(x_np.dtype, np.floating) and np.isnan(x_np).any():
        raise ValueError("NA values are not allowed.")
    x = jnp.asarray(x_np, dtype=dtype)
    return x, False, None, True


def at_highest_precision(fn):
    """Run `fn` with float32 matrix products at "highest" precision.

    On the GPU a float32 product at the default precision may run in TF32,
    which keeps about three decimal digits: ~1e-3 relative error in
    lambda_max (and so in every lambda of a generated path), in the power
    iteration, the KKT checks and predictions — the size of the 1e-3*scale
    coefficient contract itself.  The solver's own products follow
    `SolverConfig.matmul_precision` (fit_path sets it inside), so this
    governs everything around the path: preprocessing, screening,
    prediction.  On the CPU it changes nothing."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper


def _weighted_column_stats(x: jnp.ndarray, weights: jnp.ndarray):
    w = weights.reshape(-1, 1).astype(jnp.float64)
    W = jnp.maximum(jnp.sum(w), 1e-12)
    xf = x.astype(jnp.float64)
    mean = jnp.sum(xf * w, axis=0) / W
    var = jnp.sum(w * (xf - mean) ** 2, axis=0) / W
    sd = jnp.where(var == 0.0, 1.0, jnp.sqrt(var))
    return mean, sd


@at_highest_precision
def fit(
    x,
    y,
    family: str = "gaussian",
    alpha: float = 1.0,
    nlambda: int = 100,
    lambda_min_ratio: float | None = None,
    lambda_path=None,
    maxit: int = 1000,
    standardize: bool = True,
    intercept: bool = True,
    thresh: float = 0.001,
    standardize_response: bool = False,
    type_multinomial: str = "ungrouped",
    sample_weight=None,
    offset=None,
    penalty_factor=None,
    lower_limits=None,
    upper_limits=None,
    exclude=None,
    poisson_smoothness=None,
    batch_size: int = 32,
    dtype=jnp.float32,
    seed: int = 0,
    debug: bool = False,
    warm_state: SagaState | None = None,
    intercept_decay: float | None = None,
    sparse_mode: str | None = None,
    sampling: str | None = None,
    feature_names=None,
    mesh=None,
    screen: bool | str = False,
    hybrid: bool | None = None,
    hybrid_coverage: float = 0.9,
    hybrid_max_head: int = 16384,
    hybrid_memory_budget: float = 2e9,
    hybrid_head_dtype=None,
    g_sum_refresh_every: int = 1,
    lambda_chunk: int | None = None,
    step_backoff: bool = True,
) -> SgdnetFit:
    """Fit an elastic-net regularized GLM path with batched SAGA.

    API modeled on the reference's `sgdnet()` (reference R/sgdnet.R:183-199):
    `alpha` is the elastic-net mix, `lambda_path` the optional explicit
    penalty sequence, `thresh` the relative-change convergence tolerance.
    Extensions over the reference: observation weights (`sample_weight`) and
    linear-predictor offsets (`offset`) — both documented-but-unimplemented
    there (R/sgdnet.R:341-342) — grouped multinomial (unreachable from the
    reference R layer, R/sgdnet.R:265-272), `batch_size`, dtype and PRNG
    seed control.

    `offset` is a fixed per-sample term added to the linear predictor:
    shape (n,) for gaussian/binomial/poisson, (n, k) for
    multinomial/mgaussian.  For poisson pass log-exposure offsets.
    Identity-link families absorb it into the response (y - offset), exactly
    like glmnet; link families carry it through the solver, the null model,
    the null deviance, and lambda_max.  Predictions from an offset fit
    require `newoffset`.

    `penalty_factor`, `lower_limits`/`upper_limits`, and `exclude` follow
    glmnet semantics (all three are extensions; the reference has none):
    `penalty_factor` is a nonnegative (p,) vector of per-feature multipliers
    on both the L1 and L2 penalty, internally rescaled so its mean over
    non-excluded features is 1 (glmnet rescales the sum to nvars — the same
    thing); entries of 0 leave a feature unpenalized, entries of inf exclude
    it.  `lower_limits`/`upper_limits` are scalar or (p,) coefficient bounds
    on the ORIGINAL data scale (lower <= 0 <= upper required; the intercept
    is never constrained).  `exclude` is a list of feature indices forced to
    zero.  lambda_max accounts for penalty factors and exclusions; with
    zero-penalty features the first path point is not all-zero, as in glmnet.

    With `mesh` (a 1-D `jax.sharding.Mesh` over a 'data' axis) the fit runs
    data-parallel: rows and gradient memory sharded across devices,
    coefficients replicated, one psum per step (see parallel/dist.py).
    `batch_size` is then the per-device batch; the global batch is
    batch_size * n_devices.

    `screen` selects strong-rule screening of the lambda path (a rebuild
    extension; the reference always touches all p features): False (default)
    never screens, True always runs the screened driver (per-group
    dense-regime fallback), and "auto" screens while the path is in the
    measured sparse regime, then switches to one warm-started full-layout
    fit the moment the strong rule keeps more than the break-even fraction
    of features — `fit.stats["screening"]["full_tail_from"]` records the
    switch.  "auto" silently runs unscreened where screening does not apply
    (mesh, alpha == 0, debug).

    `lambda_chunk` splits the path program into warm-started chunks of that
    many lambdas, one compiled dispatch per chunk (ingestion still happens
    once).  The default (None) runs the whole path as ONE dispatch — the
    fastest schedule — but a runtime that bounds single-dispatch execution
    time can run chunked with only per-chunk dispatch overhead.

    `hybrid_max_head="auto"` sizes the dense head from the layout cost
    model (core/layout.py `plan_layout`): columns whose nonzero count
    clears the dense-stream vs gather/scatter break-even go dense, capped
    by `hybrid_memory_budget` resident bytes.  `hybrid_head_dtype` in
    {None, jnp.bfloat16, "int8"} sets head storage; reduced precisions
    halve/quarter the dominant device-memory stream and widen the auto
    head accordingly.

    Everything outside the solver's path program (preprocessing,
    screening checks) runs at "highest" matmul precision; see
    `at_highest_precision`.
    """
    # prep tracing (SGDNET_TRACE_PREP=1): stage timings with a forced device
    # sync each — async dispatch otherwise surfaces an error at the next
    # sync, far from the stage that caused it
    import os as _os
    import time as _ptime

    if _os.environ.get("SGDNET_TRACE_PREP"):
        _pt0 = _ptime.perf_counter()

        def _trace(label, sync=None):
            if sync is not None:
                try:
                    jax.block_until_ready(sync)
                    if isinstance(sync, jax.Array):
                        float(jnp.sum(jnp.ravel(sync)[:1]).astype(jnp.float32))
                except Exception as e:  # noqa: BLE001
                    print(f"[fit-prep {_ptime.perf_counter()-_pt0:7.1f}s] {label}: SYNC FAILED {e}",
                          file=__import__("sys").stderr, flush=True)
                    raise
            print(f"[fit-prep {_ptime.perf_counter()-_pt0:7.1f}s] {label}",
                  file=__import__("sys").stderr, flush=True)
    else:
        def _trace(label, sync=None):
            return None

    # ---- validation (reference R/sgdnet.R:211-263) ----
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}")
    if not 0.0 <= alpha <= 1.0:
        raise ValueError("elastic net mixing parameter (alpha) must be in [0, 1].")
    if thresh < 0:
        raise ValueError("threshold for stopping criteria cannot be negative.")
    if maxit <= 0:
        raise ValueError("maximum number of iterations cannot be negative or zero.")

    # int8 head mode: scipy inputs standardize+quantize HOST-SIDE at
    # ingestion (below) so only int8 crosses to the device; prebuilt f32
    # hybrids instead standardize on device and quantize after (quantizing
    # before centering would break the int8 representation)
    if isinstance(hybrid_head_dtype, str):
        hybrid_head_dtype = getattr(jnp, hybrid_head_dtype)
    _hybrid_int8 = hybrid_head_dtype is not None and jnp.dtype(hybrid_head_dtype) == jnp.int8

    # ---- small-problem latency: run ALL preprocessing on the LOCAL CPU
    # backend.  The prologue makes a few dozen blocking scalar readbacks
    # (stats, lambda_max, power iteration, null models); for small inputs
    # each costs more as an accelerator round trip than the computation
    # itself, so the prep runs on the host CPU backend and the assembled
    # solver inputs move to the accelerator in one device_put.  Large
    # inputs keep the accelerator path: prep there streams the matrix a few
    # times, which beats host compute + transfer.  Numerics are unchanged:
    # with x64 disabled, f64 requests truncate to f32 on BOTH backends.
    # Whether this gate still pays on the GPU is not measured.
    from contextlib import ExitStack

    _prep = ExitStack()
    _host_prep = False
    _backend = jax.default_backend()  # snapshot before any default_device change
    if (
        mesh is None
        and warm_state is None
        and _backend != "cpu"
        and not isinstance(x, (PaddedCSR, HybridCSR, jax.Array))  # already on device
    ):
        try:
            import scipy.sparse as _sp

            if _sp.issparse(x):
                # account for the dense hybrid head a scipy input may grow into
                _mh = hybrid_max_head if isinstance(hybrid_max_head, (int, np.integer)) else 16384
                _head = x.shape[0] * min(x.shape[1], _mh) if hybrid is not False and x.shape[1] > 512 else 0
                _elems = x.nnz * 3 + _head
            else:
                _elems = np.asarray(x).size
        except ImportError:
            _elems = np.asarray(x).size
        if _elems <= int(1e7):
            _host_prep = True
            try:
                _prep.enter_context(jax.default_device(jax.local_devices(backend="cpu")[0]))
            except RuntimeError:  # no CPU backend available: keep device prep
                _host_prep = False

    if hybrid_max_head == "auto":
        # measured-cost-model planner (core/layout.py): head width where the
        # column-popularity curve crosses the dense-stream vs element-op
        # break-even, capped by the head memory budget
        hybrid_max_head = 16384  # fallback for non-scipy input
        try:
            import scipy.sparse as _sp

            if _sp.issparse(x):
                from sgdnet_tpu.core.layout import plan_layout

                itemsize = (
                    1 if _hybrid_int8
                    else jnp.dtype(hybrid_head_dtype or dtype).itemsize
                )
                _plan = plan_layout(
                    x,
                    batch_size=batch_size,
                    head_itemsize=itemsize,
                    g_sum_refresh_every=g_sum_refresh_every,
                    hbm_budget=hybrid_memory_budget,
                )
                hybrid_max_head = _plan.max_head
                hybrid_coverage = 1.0  # the planner's D governs the split
        except ImportError:
            pass
    # ---- int8 hybrid ingestion, entirely HOST-SIDE: standardization is
    # fused into the host quantization (split_columns std_stats), so only
    # int8 bytes ever reach the device — no f32 head transient (building
    # the f32 head on device, standardizing, then quantizing would peak at
    # ~1x f32 head bytes: 13 GB at n=100k, D=32768, against 3.3 GB of
    # int8).  Column stats, row norms, and the NaN check run in numpy;
    # lambda_max / power iteration run on the device int8 ops (identical to
    # what the solver itself streams).
    _pre_std = None  # (mean, sd) in ORIGINAL column order when host-standardized
    _pre_row_sq = None  # host-computed per-row squared norms of the solver design
    _scipy_x = None
    if _hybrid_int8 and hybrid is not False:
        try:
            import scipy.sparse as _sp

            if _sp.issparse(x) and (hybrid or x.shape[1] > 512):
                _scipy_x = x.tocsr()
        except ImportError:
            pass
    if _scipy_x is not None:
        from sgdnet_tpu.core.sparse import scipy_column_stats, scipy_row_sq_norms

        if np.isnan(_scipy_x.data).any():
            raise ValueError("NA values are not allowed.")
        _w_host = None if sample_weight is None else np.asarray(sample_weight, np.float64)
        _split_kw = dict(
            coverage=hybrid_coverage, max_head=hybrid_max_head,
            memory_budget=hybrid_memory_budget, head_dtype=jnp.int8,
            dtype=dtype, as_host=True, head_form="nnz",
        )
        if standardize:
            _m_o, _s_o = scipy_column_stats(_scipy_x, _w_host)
            _pre_row_sq = scipy_row_sq_norms(_scipy_x, _m_o, _s_o)
            _xh, col_perm = HybridCSR.split_columns(_scipy_x, std_stats=(_m_o, _s_o), **_split_kw)
            _pre_std = (_m_o, _s_o)
        else:
            _pre_row_sq = scipy_row_sq_norms(_scipy_x)
            _xh, col_perm = HybridCSR.split_columns(_scipy_x, **_split_kw)
        # upload head + tail; KEEP the tail host-side too — the BlockCOO
        # packing below needs numpy, and a device tail would have to be read
        # back for it.  The head goes up in NONZERO form (~9 bytes/nnz) and
        # the dense int8 block is rebuilt on device (materialize_int8_head),
        # so neither a dense upload nor a host-side (n, D) block is needed.
        from sgdnet_tpu.core.sparse import materialize_int8_head

        _host_tail = _xh.tail  # numpy container
        x = HybridCSR(
            materialize_int8_head(_xh.head),
            PaddedCSR(
                jnp.asarray(_host_tail.indices), jnp.asarray(_host_tail.values),
                jnp.asarray(_host_tail.nnz), _xh.n_rows, _xh.n_cols,
            ),
            _xh.n_rows, _xh.n_cols,
            head_scale=None if _xh.head_scale is None else jnp.asarray(_xh.head_scale),
        )
        _xh = None
        is_sparse = True
        _nan_checked = True
        _trace("int8 host ingestion: layout uploaded", x.head)
        _scipy_x = None  # free the host CSR
    else:
        _host_tail = None
        x, is_sparse, col_perm, _nan_checked = _as_design_matrix(
            x,
            dtype,
            hybrid=hybrid,
            hybrid_coverage=hybrid_coverage,
            hybrid_max_head=hybrid_max_head,
            hybrid_memory_budget=hybrid_memory_budget,
            hybrid_head_dtype=None if _hybrid_int8 else hybrid_head_dtype,
        )
    n_samples, n_features = x.shape
    if n_samples == 0:
        raise ValueError("the predictor matrix (x) is empty.")

    # device-side NaN check ONLY for prebuilt device layouts — every other
    # ingestion path validated host-side (each eager bool() is a device
    # round trip; keep them out of the prologue).
    if _host_tail is None and not _nan_checked:
        x_vals = x.values if isinstance(x, PaddedCSR) else x.head if isinstance(x, HybridCSR) else x
        if x_vals.dtype == jnp.int8:  # prebuilt quantized head cannot hold NaN
            x_vals = x_vals[:0].astype(jnp.float32)
        if bool(jnp.isnan(x_vals).any()) or (
            isinstance(x, HybridCSR) and bool(jnp.isnan(x.tail.values).any())
        ):
            raise ValueError("NA values are not allowed.")

    y_arr = np.asarray(y)
    if y_arr.shape[0] != n_samples:
        raise ValueError("the number of samples in 'x' and 'y' must match")
    if y_arr.shape[0] == 0:
        raise ValueError("the response (y) is empty.")
    if y_arr.dtype != object and np.issubdtype(y_arr.dtype, np.number) and np.isnan(
        y_arr.astype(np.float64)
    ).any():
        raise ValueError("NA values are not allowed.")

    if lambda_path is not None:
        lambda_path = np.atleast_1d(np.asarray(lambda_path, dtype=np.float64))
        if (lambda_path < 0).any():
            raise ValueError("penalty strengths (lambdas) must be positive.")
        nlambda = len(lambda_path)
    if nlambda == 0:
        raise ValueError("lambda path cannot be of zero length.")

    # ---- penalty factors / exclusions / box constraints (glmnet-style
    # extensions; the reference has none of the three) ----
    excl_mask = None
    if exclude is not None:
        ex = np.atleast_1d(np.asarray(exclude, dtype=np.int64)).ravel()
        if ex.size and (ex.min() < 0 or ex.max() >= n_features):
            raise ValueError("exclude indices must be in [0, n_features)")
        excl_mask = np.zeros(n_features, dtype=bool)
        excl_mask[ex] = True

    pf_np = None
    if penalty_factor is not None:
        pf_np = np.asarray(penalty_factor, dtype=np.float64).ravel()
        if pf_np.shape != (n_features,):
            raise ValueError("penalty_factor must have one entry per feature")
        if (pf_np < 0).any() or np.isnan(pf_np).any():
            raise ValueError("penalty_factor entries must be nonnegative")
        inf_pf = np.isinf(pf_np)
        if inf_pf.any():  # glmnet: infinite penalty factor == exclude
            excl_mask = inf_pf if excl_mask is None else (excl_mask | inf_pf)
            pf_np = np.where(inf_pf, 1.0, pf_np)

    lower_np = upper_np = None
    if lower_limits is not None:
        lower_np = np.broadcast_to(
            np.asarray(lower_limits, dtype=np.float64), (n_features,)
        ).copy()
        if (lower_np > 0).any():
            raise ValueError("lower_limits must be <= 0 (coefficients start at zero)")
    if upper_limits is not None:
        upper_np = np.broadcast_to(
            np.asarray(upper_limits, dtype=np.float64), (n_features,)
        ).copy()
        if (upper_np < 0).any():
            raise ValueError("upper_limits must be >= 0 (coefficients start at zero)")

    if col_perm is not None:  # hybrid layout permutes columns: user vectors
        # are in ORIGINAL column order; internal column j is col_perm[j]
        if pf_np is not None:
            pf_np = pf_np[col_perm]
        if excl_mask is not None:
            excl_mask = excl_mask[col_perm]
        if lower_np is not None:
            lower_np = lower_np[col_perm]
        if upper_np is not None:
            upper_np = upper_np[col_perm]

    if pf_np is not None:
        # rescale: mean over non-excluded features = 1 (glmnet rescales the
        # sum to nvars — identical up to exclusion bookkeeping)
        sel = ~excl_mask if excl_mask is not None else np.ones(n_features, bool)
        if sel.any():
            m = float(pf_np[sel].mean())
            if m > 0:
                pf_np = pf_np / m

    lam_col_mult = None
    if pf_np is not None or excl_mask is not None:
        base = pf_np if pf_np is not None else np.ones(n_features)
        penalized = base > 0
        if excl_mask is not None:
            penalized &= ~excl_mask
        lam_col_mult = jnp.asarray(
            np.where(penalized, 1.0 / np.maximum(base, 1e-300), 0.0)
        )

    # ---- response encoding (reference R/sgdnet.R:277-339) ----
    fam = get_family(family, standardize_response=standardize_response)
    y_enc, classnames = fam.encode(y_arr)
    n_classes = fam.n_classes

    if family == "poisson":
        # data-dependent curvature bound for the exp link (see families.py
        # Poisson docstring); power-of-two rounding bounds jit retraces
        if poisson_smoothness is None:
            ym = y_enc[:, 0]
            bound = max(float(ym.max()) * 2.0, float(ym.mean()) * 4.0, 2.0)
        else:
            bound = float(poisson_smoothness)
        fam = get_family("poisson", smoothness=float(2.0 ** np.ceil(np.log2(bound))))

    # ---- linear-predictor offset (extension; documented-but-unimplemented
    # in the reference, R/sgdnet.R:341-342) ----
    offset_arr = None
    if offset is not None:
        offset_arr = np.asarray(offset, dtype=np.float64)
        if offset_arr.ndim == 1:
            offset_arr = offset_arr.reshape(-1, 1)
        kk = n_classes if family in ("multinomial", "mgaussian") else 1
        if offset_arr.shape != (n_samples, kk):
            want = f"({n_samples},)" if kk == 1 else f"({n_samples}, {kk})"
            raise ValueError(f"offset must have shape {want} for family '{family}'")
        if np.isnan(offset_arr).any():
            raise ValueError("NA values are not allowed.")
        if family in ("gaussian", "mgaussian"):
            # identity link: absorb into the response (glmnet does the same)
            y_enc = y_enc - offset_arr
            offset_arr_internal = None
        else:
            offset_arr_internal = offset_arr

    y_dev = jnp.asarray(y_enc, dtype=dtype)

    grouped = family == "mgaussian" or (family == "multinomial" and type_multinomial == "grouped")
    penalty = select_penalty(alpha, family, type_multinomial)

    if sample_weight is None:
        weights_np = np.ones((n_samples,), dtype=np.float64)
    else:
        weights_np = np.asarray(sample_weight, dtype=np.float64)
        if weights_np.shape != (n_samples,):
            raise ValueError("sample_weight must have one entry per sample")
        if (weights_np < 0).any():
            raise ValueError("sample_weight must be nonnegative")
    weights = jnp.asarray(weights_np, dtype=dtype)
    w_total = float(weights_np.sum())
    if w_total <= 0:
        raise ValueError("sample weights sum to zero")

    # ---- feature standardization (reference src/sgdnet.cpp:143-151) ----
    xc = None  # sparse centering correction term (center/scale)
    # weighted stats everywhere (same formula as the dense path; for unit
    # weights it reduces to the reference's unweighted stats exactly)
    w_stats = None if sample_weight is None else jnp.asarray(weights_np)
    if standardize:
        if _pre_std is not None:
            # host-ingestion path: x is ALREADY standardized (head fully
            # centered+scaled inside the int8 quantization, tail scale-only)
            # — materialize the stats in internal (permuted) column order
            # and the tail centering correction (zero on head columns)
            _m_o, _s_o = _pre_std
            x_center = jnp.asarray(_m_o[col_perm])
            x_scale = jnp.asarray(_s_o[col_perm])
            xc_np = _m_o[col_perm] / _s_o[col_perm]
            xc_np[: x.n_head] = 0.0
            xc = jnp.asarray(xc_np, dtype)
        elif isinstance(x, HybridCSR):
            x_center, x_scale = x.column_stats(w_stats)
            # donate the head iff fit built it (scipy ingestion): XLA then
            # aliases the multi-GB f32 buffer in place instead of copying
            x, xc = x.standardize(x_center, x_scale, donate=col_perm is not None)
            xc = xc.astype(dtype)
        elif is_sparse:
            x_center64, x_scale64 = x.column_stats(w_stats)
            x = x.scale_columns(x_scale64)
            xc = (x_center64 / x_scale64).astype(dtype)
            x_center, x_scale = x_center64, x_scale64
        else:
            x_center, x_scale = _weighted_column_stats(x, weights)
            x = ((x.astype(jnp.float64) - x_center) / x_scale).astype(dtype)
    else:
        x_center = jnp.zeros((n_features,), jnp.float64)
        x_scale = jnp.ones((n_features,), jnp.float64)

    # ---- null deviance on the original response (src/sgdnet.cpp:154) ----
    offs_link64 = None
    b0_offs = None  # offset null intercept, solved once and reused below
    if offset_arr is not None and offset_arr_internal is not None:
        offs_link64 = jnp.asarray(offset_arr_internal)
    if offs_link64 is not None:
        b0_offs = fam.null_intercept_offset(
            y_dev.astype(jnp.float64), offs_link64, intercept, weights.astype(jnp.float64)
        )
        nulldev = float(
            fam.null_deviance_offset(
                y_dev.astype(jnp.float64), offs_link64, intercept,
                weights.astype(jnp.float64), b0=b0_offs,
            )
        )
    else:
        nulldev = float(
            fam.null_deviance(y_dev.astype(jnp.float64), intercept, weights.astype(jnp.float64))
        )

    # ---- response preprocessing (always, src/sgdnet.cpp:158) ----
    w64 = weights.astype(jnp.float64) if sample_weight is not None else None
    y_proc64, y_center, y_scale = fam.preprocess(y_dev.astype(jnp.float64), w64)
    y_proc = y_proc64.astype(dtype)
    offs64 = None if offs_link64 is None else offs_link64 / y_scale[None, :]

    # ---- internal coefficient bounds on the standardized solver scale:
    # beta_orig = w_std * y_scale / x_scale, so bounds map by x_scale/y_scale;
    # excluded features are pinned at [0, 0] ----
    box = None
    pf_dev = None if pf_np is None else jnp.asarray(pf_np, dtype)
    if lower_np is not None or upper_np is not None or excl_mask is not None:
        lo = lower_np if lower_np is not None else np.full(n_features, -np.inf)
        hi = upper_np if upper_np is not None else np.full(n_features, np.inf)
        if excl_mask is not None:
            lo, hi = lo.copy(), hi.copy()
            lo[excl_mask] = 0.0
            hi[excl_mask] = 0.0
        if (lo > hi).any():
            raise ValueError("lower_limits must be <= upper_limits")
        xs_np = np.asarray(x_scale, dtype=np.float64)
        ys_np = np.asarray(y_scale, dtype=np.float64)
        box = (
            jnp.asarray(lo[None, :] * xs_np[None, :] / ys_np[:, None], dtype),
            jnp.asarray(hi[None, :] * xs_np[None, :] / ys_np[:, None], dtype),
        )

    # ---- lambda path (reference src/utils.h:142-181) ----
    if lambda_path is None:
        if offs64 is not None:
            from sgdnet_tpu.families.families import lambda_max_offset

            lam_max = float(
                lambda_max_offset(
                    fam, x, y_proc64, offs64, y_scale, intercept, w64, b0=b0_offs,
                    col_mult=lam_col_mult,
                )
            ) / max(alpha, 0.001)
        else:
            lam_max = float(
                fam.lambda_max(x, y_proc64, y_scale, w64, col_mult=lam_col_mult)
            ) / max(alpha, 0.001)
        if lam_max > 0.0 and np.isfinite(lam_max):
            if lambda_min_ratio is None:
                lambda_min_ratio = 0.01 if n_samples < n_features else 1e-4
            lambdas = np.exp(np.linspace(np.log(lam_max), np.log(lam_max * lambda_min_ratio), nlambda))
        else:
            lambdas = np.zeros(nlambda)
    else:
        lambdas = lambda_path

    _trace("nulldev + preprocess + lambda path")
    max_scale = float(jnp.max(y_scale))
    l2s = (1.0 - alpha) * lambdas / max_scale  # reference's `alpha` (src/utils.h:176)
    l1s = alpha * lambdas / max_scale  # reference's `beta` (src/utils.h:178)

    # ---- step sizes (reference src/utils.h:31-51 + minibatch extension) ----
    active = (weights > 0).astype(jnp.float64)
    per_row = None
    if _pre_row_sq is not None:
        # host-ingestion path: exact standardized row norms straight from
        # numpy — no device round-trip (and the device equivalent would
        # dequantize the whole int8 head)
        max_sq = float(np.max(_pre_row_sq * (weights_np > 0)))
    elif isinstance(x, HybridCSR):
        per_row = x.row_squared_norms(xc)
    elif is_sparse:
        # squared norms of (scaled, centered) rows without densifying
        vals64 = x.values.astype(jnp.float64)
        per_row = jnp.sum(vals64**2, axis=1)
        if xc is not None:
            c = xc.astype(jnp.float64)
            cross = jnp.sum(vals64 * c[x.indices], axis=1)
            per_row = per_row - 2.0 * cross + jnp.sum(c**2)
    else:
        per_row = jnp.sum(x.astype(jnp.float64) ** 2, axis=1)
    if per_row is not None:
        max_sq = float(jnp.max(per_row * active))

    if batch_size > 1:
        top_sq = float(power_iteration_sq_norm(x, xc)) / w_total
    else:
        top_sq = None
    _trace("row norms + power iteration")
    gammas = saga_step_sizes(
        max_sq, top_sq, jnp.asarray(l2s), w_total, batch_size, intercept, fam.L_scaling
    )

    # int8 head quantization EARLY (everything above — stats, lambda max,
    # row norms, power iteration — runs on the exact f32 standardized head;
    # everything below only permutes/pads rows, and per-column quantization
    # commutes BITWISE with row shuffle and zero-row padding, so the fitted
    # problem is identical to quantizing last).  Doing it here means the
    # shuffle and pad copy int8, not f32: peak transient drops from ~2x f32
    # head bytes (which crashed a D=16384 fit on the 16 GB chip) to ~1.25x.
    if _hybrid_int8 and isinstance(x, HybridCSR):
        x = x.quantize_head(donate=col_perm is not None)

    # ---- pad rows to a multiple of batch_size (x shards, if meshed) ----
    if mesh is not None:
        from sgdnet_tpu.parallel.dist import pad_to_shards

        n_pad = pad_to_shards(n_samples, mesh.devices.size, batch_size)
    else:
        n_pad = ((n_samples + batch_size - 1) // batch_size) * batch_size
    if sampling is None:
        # big-data default: contiguous-block batches read device memory in
        # order instead of gathering rows; same fixed point, so the 1e-3
        # contract is unaffected.
        # With an externally supplied warm_state, stay with permutation —
        # block mode pre-shuffles rows and would misalign a g_mem saved
        # under a different order (refits pass `sampling` explicitly).
        if warm_state is not None:
            sampling = "permutation"
        else:
            sampling = "block" if n_samples >= 32768 else "permutation"
    if sampling not in ("permutation", "block"):
        raise ValueError("sampling must be 'permutation' or 'block'")
    if sampling == "block":
        # Block sampling draws fixed contiguous row blocks in random order
        # (in-order reads instead of row gathers).
        # Shuffle rows once so blocks are random samples even for ordered
        # input.  Seed-deterministic, so warm_state from a fit with the same
        # seed+sampling stays row-aligned.
        rperm_np = np.random.default_rng(seed + 0x5EED).permutation(n_samples)
        rperm = jnp.asarray(rperm_np)
        if isinstance(x, HybridCSR):
            tail = PaddedCSR(
                x.tail.indices[rperm], x.tail.values[rperm], x.tail.nnz[rperm],
                x.tail.n_rows, x.tail.n_cols,
            )
            x = HybridCSR(
                x.head[rperm], tail, x.n_rows, x.n_cols, head_scale=x.head_scale
            )
            if _host_tail is not None:  # keep the host mirror row-aligned
                _host_tail = PaddedCSR(
                    _host_tail.indices[rperm_np], _host_tail.values[rperm_np],
                    _host_tail.nnz[rperm_np], _host_tail.n_rows, _host_tail.n_cols,
                )
        elif isinstance(x, PaddedCSR):
            x = PaddedCSR(x.indices[rperm], x.values[rperm], x.nnz[rperm], x.n_rows, x.n_cols)
        else:
            x = x[rperm]
        y_proc = y_proc[rperm]
        weights = weights[rperm]
        if offs64 is not None:
            offs64 = offs64[rperm]

    _trace("row shuffle dispatched", x.head if (sampling == "block" and isinstance(x, HybridCSR)) else None)
    offs_dev = None if offs64 is None else offs64.astype(dtype)
    if n_pad > n_samples:
        extra = n_pad - n_samples
        if is_sparse:
            x = x.pad_rows(n_pad)
            if _host_tail is not None:
                _L = _host_tail.row_width
                _host_tail = PaddedCSR(
                    np.concatenate([_host_tail.indices, np.zeros((extra, _L), np.int32)]),
                    np.concatenate([_host_tail.values, np.zeros((extra, _L), _host_tail.values.dtype)]),
                    np.concatenate([_host_tail.nnz, np.zeros((extra,), np.int32)]),
                    n_pad, _host_tail.n_cols,
                )
        else:
            x = jnp.concatenate([x, jnp.zeros((extra, n_features), x.dtype)])
        y_proc = jnp.concatenate([y_proc, jnp.zeros((extra, y_proc.shape[1]), y_proc.dtype)])
        weights = jnp.concatenate([weights, jnp.zeros((extra,), weights.dtype)])
        if offs_dev is not None:
            offs_dev = jnp.concatenate([offs_dev, jnp.zeros((extra, offs_dev.shape[1]), offs_dev.dtype)])

    # block sampling + hybrid layout: pack the tail's true nonzeros per block
    # (BlockCOO) — the padded tail pays serialized gather/scatter work on its
    # ~2/3 padding; the packed view cuts the tail element-ops accordingly.
    # Sharded fits pack too: blocks are contiguous row ranges and rows-per-shard
    # is a batch multiple, so sharding the block axis IS the row partition
    # (shard_inputs places blk_tail with P('data', None)).
    if sampling == "block" and isinstance(x, HybridCSR):
        from sgdnet_tpu.core.sparse import BlockCOO

        x = HybridCSR(
            x.head, x.tail, x.n_rows, x.n_cols,
            # pack from the host tail mirror when ingestion kept one:
            # from_padded on device arrays reads the tail back first
            blk_tail=BlockCOO.from_padded(
                _host_tail if _host_tail is not None else x.tail, batch_size
            ),
            head_scale=x.head_scale,
        )

    _trace("pad + blockcoo ready", getattr(getattr(x, 'blk_tail', None), 'vals', None))
    # safety net: int8 heads are normally quantized EARLY (above, before the
    # shuffle/pad — bitwise-identical, far smaller transients); this no-ops
    # then, and covers any future path that reaches here with an f32 head.
    # See HybridCSR.quantize_head for the fixed-point argument.
    if _hybrid_int8 and isinstance(x, HybridCSR):
        x = x.quantize_head()

    # ---- solver state (reference src/sgdnet.cpp:187-211) ----
    if warm_state is None:
        state0 = init_state(n_pad, n_features, n_classes, dtype)
        # intercept warm-started at the null model (src/sgdnet.cpp:210)
        if offs_dev is not None:
            null_int = b0_offs  # same solve: y_proc == y_dev, y_scale == 1 here
        else:
            null_int = fam.null_intercept(
                y_proc.astype(jnp.float64)[:n_pad], intercept, weights.astype(jnp.float64)
            )
        state0 = state0._replace(intercept=null_int.astype(dtype))
    else:
        state0 = warm_state

    if offs_dev is not None:
        null_dev_scaled = float(
            fam.null_deviance_offset(
                y_proc.astype(jnp.float64), offs_dev.astype(jnp.float64), intercept,
                weights.astype(jnp.float64), b0=b0_offs,
            )
        )
    else:
        null_dev_scaled = float(
            fam.null_deviance(y_proc.astype(jnp.float64), intercept, weights.astype(jnp.float64))
        )

    if intercept_decay is None:
        # reference sparse quirk (src/saga-sparse.h:300-304) — but not for
        # poisson: the exp link makes every rate exponentially sensitive to
        # the intercept, and a 100x-damped intercept stalls the whole fit
        intercept_decay = 0.01 if (is_sparse and family != "poisson") else 1.0
    if sparse_mode is None:
        sparse_mode = "densify" if n_features <= 8192 else "gather"

    config = SolverConfig(
        batch_size=batch_size,
        max_iter=maxit,
        fit_intercept=intercept,
        intercept_decay=intercept_decay,
        g_sum_refresh=True,
        g_sum_refresh_every=g_sum_refresh_every,
        sparse_mode=sparse_mode,
        sampling=sampling,
        step_backoff=step_backoff,
        debug=debug,
        axis_name=None if mesh is None else "data",
    )

    # host-CPU preprocessing ends here: move the assembled solver inputs to
    # the accelerator in ONE transfer (CPU-committed arrays would otherwise
    # pin the jitted path program to the CPU backend)
    _prep.close()
    if _host_prep:
        _tgt = jax.devices()[0]
        (x, y_proc, weights, xc, offs_dev, pf_dev, box, state0, gammas) = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, _tgt) if isinstance(a, jax.Array) else a,
            (x, y_proc, weights, xc, offs_dev, pf_dev, box, state0, gammas),
        )

    _trace("state + solver inputs ready")
    import time as _time

    _t0 = _time.perf_counter()
    key = jax.random.PRNGKey(seed)
    path_args = (
        jnp.asarray(gammas, dtype),
        jnp.asarray(l1s, dtype),
        jnp.asarray(l2s, dtype),
        jnp.asarray(thresh, dtype),
        key,
        state0,
        fam,
        penalty,
        config,
    )
    if screen not in (False, True, "auto"):
        raise ValueError(f"screen must be False, True, or 'auto'; got {screen!r}")
    if screen == "auto":
        # regime-aware screening (round 5): screened groups while the strong
        # rule keeps the active set sparse, then ONE warm-started full-layout
        # fit for the rest of the path the moment the dense-regime boundary
        # (full_fallback_frac, the measured break-even) is crossed — the
        # sparse-regime 1.48x win without the user knowing the regime.
        # Ineligible configurations (mesh / ridge / debug) silently run the
        # normal unscreened schedule: "auto" chooses, it never errors.
        screen = "auto" if (mesh is None and alpha > 0.0 and not debug) else False
    if screen:
        # sequential strong-rule screening with KKT safety checks
        # (solver/screening.py) — single-device, l1 > 0 paths; all layouts,
        # penalty factors, box limits, exclusions (round 2) and offsets
        # (round 3: they only shift the full-data linear predictors)
        if mesh is not None or alpha == 0.0 or debug:
            raise ValueError(
                "screen=True requires a single device, alpha > 0, and debug=False"
            )
        from types import SimpleNamespace

        from sgdnet_tpu.solver.screening import screened_path

        w_scr, b_scr, dev_scr, it_scr, codes_scr, n_iter, scr_stats = screened_path(
            x, y_proc, weights, gammas, l1s, l2s, thresh, key, fam, penalty, config,
            xc=xc, pf=pf_dev, box=box, always_inactive=excl_mask,
            offs=offs_dev, intercept0=b0_offs if offs_dev is not None else None,
            auto_full_tail=(screen == "auto"),
            full_tail_chunk=lambda_chunk,
        )
        state = None
        results = SimpleNamespace(
            w=w_scr,
            intercept=b_scr,
            deviance=dev_scr,
            n_epochs=it_scr,
            return_codes=codes_scr,
            losses=np.zeros((len(l1s), 0)),
            clamp_gap=np.zeros(len(l1s)),
        )
    elif mesh is None:
        if lambda_chunk is None or lambda_chunk >= len(l1s):
            state, n_iter, results = fit_path(
                x, y_proc, weights, xc, *path_args, offs=offs_dev, pf=pf_dev, box=box
            )
        else:
            # chunked path: same warm-started semantics, one dispatch per
            # `lambda_chunk` lambdas; each chunk's results are read back
            # eagerly so a killed dispatch loses only its own chunk.
            # Per-chunk step backoff, try-and-keep-the-better: a chunk with
            # a suspicious exit (code 1 AND final relative change far above
            # tol — the expected-smoothness step measurably OSCILLATES
            # mid-path where the active set densifies) is refit from its
            # pre-chunk state with gammas halved; the retry is kept only if
            # it actually does better (fewer non-converged lambdas, then
            # lower deviance).  Slow-but-monotone code-1 fits therefore keep
            # their original trajectory (halving gamma would make them
            # strictly worse), while a genuine oscillation is replaced by a
            # convergent fit (the halving then sticks for deeper lambdas).
            # All attempts count toward npasses.
            gam_d, l1_d, l2_d, thr_d, _key, _st, _fam, _pen, _cfg = path_args
            state = _st
            n_iter = 0
            _parts = []
            _bk = 0  # halvings applied so far

            def _run_chunk(_sl, _lo, _state_in, _gmul, _try):
                st_, it_, res_ = fit_path(
                    x, y_proc, weights, xc,
                    gam_d[_sl] * _gmul, l1_d[_sl], l2_d[_sl], thr_d,
                    jax.random.fold_in(_key, _lo + 1000 * _try), _state_in,
                    _fam, _pen, _cfg,
                    offs=offs_dev, pf=pf_dev, box=box,
                )
                it_, res_ = jax.device_get((it_, res_))
                return st_, int(it_), res_

            def _suspicious(res_):
                return bool(np.any(
                    (np.asarray(res_.return_codes) == 1)
                    & (np.asarray(res_.final_change) > 10.0 * float(thresh))
                ))

            def _better(a, b):
                ca = int((np.asarray(a.return_codes) == 1).sum())
                cb = int((np.asarray(b.return_codes) == 1).sum())
                if ca != cb:
                    return ca < cb
                return float(np.asarray(a.deviance).sum()) < float(np.asarray(b.deviance).sum())

            for _lo in range(0, len(l1s), lambda_chunk):
                _sl = slice(_lo, _lo + lambda_chunk)
                _state_in = state
                state, _it, _res = _run_chunk(_sl, _lo, _state_in, 0.5 ** _bk, 0)
                n_iter += _it
                for _try in (1, 2):
                    if not _suspicious(_res):
                        break
                    st2, it2, res2 = _run_chunk(_sl, _lo, _state_in, 0.5 ** (_bk + 1), _try)
                    n_iter += it2
                    if _better(res2, _res):
                        state, _res = st2, res2
                        _bk += 1  # sticky only when the smaller step won
                        _trace(f"lambda chunk {_lo}: oscillation; gamma backoff x0.5^{_bk} kept")
                    else:
                        break  # slow-but-stable: keep the original trajectory
                _trace(f"lambda chunk {_lo} done (backoff {_bk})")
                _parts.append(_res)
            from sgdnet_tpu.solver.saga import PathResults

            results = PathResults(
                *(np.concatenate([getattr(p, f) for p in _parts])
                  for f in PathResults._fields)
            )
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from sgdnet_tpu.parallel.dist import fit_path_sharded, shard_inputs

        x, y_proc, weights = shard_inputs(mesh, x, y_proc, weights)
        if offs_dev is not None:
            offs_dev = jax.device_put(offs_dev, NamedSharding(mesh, P("data", None)))
        state0 = state0._replace(
            g_mem=jax.device_put(state0.g_mem, NamedSharding(mesh, P("data", None)))
        )
        path_args = path_args[:5] + (state0,) + path_args[6:]
        state, n_iter, results = fit_path_sharded(
            x, y_proc, weights, xc, *path_args, mesh=mesh, offs=offs_dev, pf=pf_dev, box=box
        )

    # ---- rescale to original units (reference src/utils.h:352-378) ----
    if not screen:
        # ONE bulk device->host transfer for every path output (each
        # np.asarray below would otherwise be its own device sync)
        n_iter, results = jax.device_get((n_iter, results))
    w_path = np.asarray(results.w, dtype=np.float64)  # (nl, k, p)
    _wall = _time.perf_counter() - _t0
    if isinstance(x, (PaddedCSR, HybridCSR)):
        _nnz_per_epoch = x.total_nnz()
    else:
        _nnz_per_epoch = n_pad * n_features
    _epochs = int(n_iter)
    _stats = {
        "wall_time_s": _wall,
        "epochs": _epochs,
        "nnz": _nnz_per_epoch * max(_epochs, 1),
        "nnz_per_s": _nnz_per_epoch * max(_epochs, 1) / max(_wall, 1e-9),
    }
    if isinstance(x, HybridCSR):
        _stats["layout"] = {
            "kind": "hybrid", "head_width": x.n_head,
            "head_dtype": str(x.head.dtype), "blk_tail": x.blk_tail is not None,
        }
    elif isinstance(x, PaddedCSR):
        _stats["layout"] = {"kind": "padded_csr", "row_width": x.row_width}
    else:
        _stats["layout"] = {"kind": "dense"}
    if screen:
        # screening effectiveness: mean active-set size vs p — the fraction
        # of per-epoch coefficient work the strong rule actually removed
        _stats["screening"] = scr_stats
        # WORK-based throughput (round 4): under screening the epochs ran on
        # dense active-set subproblems a fraction of the full width, so the
        # full-design figure would overstate work done.  `nnz`/`nnz_per_s`
        # count the elements the solver actually streamed
        # (screening.work_elems); the full-matrix figure stays available as
        # `coverage_nnz`, clearly labeled coverage, not work.
        _work = scr_stats.get("work_elems", _stats["nnz"])
        _stats["coverage_nnz"] = _stats["nnz"]
        _stats["nnz"] = _work
        _stats["nnz_per_s"] = _work / max(_wall, 1e-9)
    b_path = np.asarray(results.intercept, dtype=np.float64)  # (nl, k)
    x_scale_np = np.asarray(x_scale)
    x_center_np = np.asarray(x_center)
    y_scale_np = np.asarray(y_scale)
    y_center_np = np.asarray(y_center)

    beta = w_path * y_scale_np[None, :, None] / x_scale_np[None, None, :]
    # snap numerical residue to exact zero so sparsity patterns (df, nonzero)
    # match the reference's exact-prox zeros
    tiny = 10 * np.finfo(np.asarray(results.w).dtype).eps * max(1.0, np.abs(beta).max())
    beta[np.abs(beta) < tiny] = 0.0
    a0 = b_path * y_scale_np[None, :]
    if intercept:
        a0 = a0 + y_center_np[None, :] - np.einsum("j,lkj->lk", x_center_np, beta)

    # multinomial intercepts re-centered to sum 0 (reference R/sgdnet.R:409-410)
    if family == "multinomial":
        a0 = a0 - a0.mean(axis=1, keepdims=True)

    if col_perm is not None:  # undo the hybrid head/tail column permutation
        unperm = np.empty_like(beta)
        unperm[:, :, col_perm] = beta
        beta = unperm

    dev = np.asarray(results.deviance, dtype=np.float64)
    if null_dev_scaled != 0.0:
        dev_ratio = 1.0 - dev / null_dev_scaled
    else:  # degenerate constant-response case
        dev_ratio = np.zeros_like(dev)

    clamp_gap = np.asarray(getattr(results, "clamp_gap", np.zeros(1)), dtype=np.float64)
    if family == "poisson" and (
        np.nanmax(np.abs(clamp_gap)) > 1e-6 * max(abs(null_dev_scaled), 1.0)
        or not np.isfinite(dev).all()
    ):
        import warnings

        warnings.warn(
            "the poisson smoothness clamp is active at the fitted solution "
            "for at least one lambda: the reported deviance is exact but the "
            "solver optimized the clamped objective — refit with a larger "
            "`poisson_smoothness` for a reliable fit.",
            RuntimeWarning,
            stacklevel=2,
        )

    nz = np.abs(beta) > 0
    df = nz.any(axis=1).sum(axis=1)  # features nonzero in any class
    dfmat = nz.sum(axis=2).T if n_classes > 1 else None  # (k, nl)

    diagnostics = None
    if debug:
        diagnostics = {"loss": np.asarray(results.losses, dtype=np.float64)}

    fit_obj = SgdnetFit(
        a0=a0 if n_classes > 1 else a0[:, 0],
        beta=beta,
        lambda_=np.asarray(lambdas, dtype=np.float64),
        dev_ratio=dev_ratio,
        df=df,
        dfmat=dfmat,
        nulldev=nulldev,
        npasses=int(n_iter),
        return_codes=np.asarray(results.return_codes),
        alpha=alpha,
        family=family,
        classnames=classnames,
        grouped=grouped,
        nobs=n_samples,
        offset=offset_arr is not None,
        feature_names=list(feature_names) if feature_names is not None else None,
        diagnostics=diagnostics,
        final_state=state,
        stats=_stats,
    )
    fit_obj._refit_args = dict(
        family=family,
        alpha=alpha,
        maxit=maxit,
        standardize=standardize,
        intercept=intercept,
        thresh=thresh,
        standardize_response=standardize_response,
        type_multinomial=type_multinomial,
        batch_size=batch_size,
        dtype=dtype,
        seed=seed,
        sampling=sampling,
        sample_weight=weights_np if sample_weight is not None else None,
        offset=offset_arr if offset_arr is not None else None,
        penalty_factor=penalty_factor,
        lower_limits=lower_limits,
        upper_limits=upper_limits,
        exclude=exclude,
        poisson_smoothness=poisson_smoothness,
        # layout / performance options — a refit (predict(exact=True)) must
        # run on the same layout and device placement as the original fit
        mesh=mesh,
        hybrid=hybrid,
        hybrid_coverage=hybrid_coverage,
        hybrid_max_head=hybrid_max_head,
        hybrid_memory_budget=hybrid_memory_budget,
        hybrid_head_dtype=hybrid_head_dtype,
        sparse_mode=sparse_mode,
        g_sum_refresh_every=g_sum_refresh_every,
        intercept_decay=intercept_decay,
        lambda_chunk=lambda_chunk,
    )
    return fit_obj
