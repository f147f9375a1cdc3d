"""GLM response families.

Accelerator re-design of the reference's Family hierarchy
(reference src/families.h:26-410).  Each family exposes *batched*,
jit-safe loss/gradient kernels operating on (B, k) blocks of linear
predictors — the per-sample scalar methods of the reference become
vectorized elementwise ops, and everything else stays matmul-shaped.

Internal response encoding (host-side `encode`):
    gaussian    y -> (n, 1) float
    binomial    y -> (n, 1) float in {0, 1}   (reference R/sgdnet.R:306)
    multinomial y -> (n, K) one-hot           (reference keeps integer codes;
                                               one-hot keeps the gradient a
                                               pure matmul/softmax kernel)
    mgaussian   y -> (n, m) float

All deviances follow the reference convention deviance = 2 * sum(loss)
(reference src/utils.h:304-329).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sgdnet_tpu.core.linalg import clamp, column_mean, column_sd, logsumexp
from sgdnet_tpu.core.sparse import HybridCSR, PaddedCSR


def _xty(x, y: jnp.ndarray) -> jnp.ndarray:
    """x.T @ y for dense, PaddedCSR, or HybridCSR x; returns (p, m)."""
    if isinstance(x, (PaddedCSR, HybridCSR)):
        dtype = x.values.dtype if isinstance(x, PaddedCSR) else x.head.dtype
        # int8/bf16 heads must not truncate y: matvec_T handles the head's
        # reduced-precision stream internally and accumulates in f32
        dtype = jnp.promote_types(dtype, jnp.float32)
        return x.matvec_T(y.astype(dtype)).astype(jnp.float64)
    return x.T.astype(jnp.float64) @ y.astype(jnp.float64)


def _wmean(y: jnp.ndarray, weights: jnp.ndarray | None) -> jnp.ndarray:
    if weights is None:
        return jnp.mean(y, axis=0)
    w = weights.reshape(-1, 1)
    return jnp.sum(y * w, axis=0) / jnp.sum(w)


def _wstats(y: jnp.ndarray, weights: jnp.ndarray):
    """Weighted per-column (mean, population SD) with zero-variance guard."""
    w = weights.reshape(-1, 1)
    W = jnp.maximum(jnp.sum(w), 1e-12)
    mean = jnp.sum(y * w, axis=0) / W
    var = jnp.sum(w * (y - mean) ** 2, axis=0) / W
    sd = jnp.where(var == 0.0, 1.0, jnp.sqrt(var))
    return mean, sd


class Family:
    """Base family protocol (reference src/families.h:26-62)."""

    name: str = "base"
    L_scaling: float = 1.0
    #: True when the response is a classification one-hot/indicator
    is_classification: bool = False

    def __init__(self, n_classes: int = 1):
        self.n_classes = n_classes

    # Families are passed to jit as static arguments; identity is defined by
    # (type, n_classes, options) so retraces only happen when those change.
    def __hash__(self):
        return hash((type(self).__name__, self.n_classes, getattr(self, "standardize_response", False)))

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.n_classes == other.n_classes
            and getattr(self, "standardize_response", False) == getattr(other, "standardize_response", False)
        )

    # ----- host-side -----
    def encode(self, y_raw):
        """Validate + encode raw response -> (y (n, ky) float64, class_names)."""
        raise NotImplementedError

    # ----- device-side (jit-safe) -----
    def preprocess(self, y: jnp.ndarray, weights: jnp.ndarray | None = None):
        """Response standardization; returns (y_t, y_center (k,), y_scale (k,))."""
        k = self.n_classes
        z = jnp.zeros((k,), y.dtype)
        return y, z, z + 1.0

    def loss(self, lp: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        """Per-sample loss; lp (B, k), y (B, ky) -> (B,)."""
        raise NotImplementedError

    def gradient(self, lp: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        """Per-sample gradient dloss/dlp; (B, k)."""
        raise NotImplementedError

    def loss_report(self, lp: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        """Loss used for REPORTED statistics (deviance, dev_ratio, debug
        traces).  Defaults to `loss`; families whose solver loss carries a
        numerical safeguard (e.g. the Poisson smoothness clamp) override this
        with the exact, unclamped loss so reported deviances are honest."""
        return self.loss(lp, y)

    def null_intercept(self, y: jnp.ndarray, fit_intercept: bool, weights=None) -> jnp.ndarray:
        """Intercept of the null (intercept-only) model; (k,)."""
        raise NotImplementedError

    def null_deviance(self, y: jnp.ndarray, fit_intercept: bool, weights=None) -> jnp.ndarray:
        """2 * sum(loss) under the null model."""
        lp0 = jnp.broadcast_to(self.null_intercept(y, fit_intercept, weights), (y.shape[0], self.n_classes))
        losses = self.loss_report(lp0, y)
        if weights is not None:
            losses = losses * weights
        return 2.0 * jnp.sum(losses)

    def lambda_max(self, x, y: jnp.ndarray, y_scale: jnp.ndarray, weights=None, col_mult=None) -> jnp.ndarray:
        """Largest lambda on the auto path (family-specific).  With
        observation weights, inner products and moments are weighted and the
        divisor is the total weight instead of n.  `col_mult` is an optional
        (p,) per-feature multiplier on the null-gradient statistic —
        1/penalty_factor, with 0 for excluded/unpenalized features (glmnet
        `penalty.factor` semantics)."""
        raise NotImplementedError

    # ----- offset-aware null model (extension; the reference documents an
    # `offset` argument but never implements it, R/sgdnet.R:341-342) -----
    def null_intercept_offset(
        self, y: jnp.ndarray, offs: jnp.ndarray, fit_intercept: bool, weights=None
    ) -> jnp.ndarray:
        """Intercept of the intercept-plus-offset null model; (k,).
        Identity-link families never reach this (their offset is folded into
        the response before fitting); link families override."""
        return self.null_intercept(y, fit_intercept, weights)

    def null_deviance_offset(
        self, y: jnp.ndarray, offs: jnp.ndarray, fit_intercept: bool, weights=None, b0=None
    ) -> jnp.ndarray:
        """2 * sum(loss) under the intercept-plus-offset null model.  Pass a
        precomputed `b0` to skip the iterative intercept solve."""
        if b0 is None:
            b0 = self.null_intercept_offset(y, offs, fit_intercept, weights)
        lp0 = b0[None, :] + offs
        losses = self.loss_report(lp0, y)
        if weights is not None:
            losses = losses * weights
        return 2.0 * jnp.sum(losses)


def _apply_col_mult(inner, col_mult):
    """Per-feature multiplier on the (p, k) null-gradient statistic.
    Penalty factors enter lambda_max as 1/pf_j; excluded or unpenalized
    (pf_j = 0) features get multiplier 0 — they never leave the model, so
    they do not set the path start (glmnet does the same)."""
    if col_mult is None:
        return inner
    return inner * col_mult.astype(inner.dtype)[:, None]


def lambda_max_offset(fam: Family, x, y: jnp.ndarray, offs: jnp.ndarray, y_scale: jnp.ndarray, fit_intercept: bool, weights=None, b0=None, col_mult=None) -> jnp.ndarray:
    """Generic lambda_max = max-norm of the null-model gradient.

    Every family-specific `lambda_max` above equals the (weighted) gradient
    of the loss at the null model — e.g. the binomial formula
    y_std * max|x^T (y - ybar)/y_std| / n (reference src/families.h:203-220)
    is exactly max|x^T (sigma(b0) - y)| / n.  With an offset the null model
    is intercept-plus-offset, so we evaluate that gradient directly.

    Only link families (binomial/multinomial) reach this: identity-link
    families fold the offset into the response and use `lambda_max`."""
    if b0 is None:
        b0 = fam.null_intercept_offset(y, offs, fit_intercept, weights)
    g = fam.gradient(b0[None, :] + offs, y)
    if weights is not None:
        g = g * weights.reshape(-1, 1)
        W = jnp.maximum(jnp.sum(weights), 1e-12)
    else:
        W = y.shape[0]
    inner = _xty(x, g) * y_scale[None, :].astype(jnp.float64)
    return jnp.max(jnp.abs(_apply_col_mult(inner, col_mult))) / W


class Gaussian(Family):
    """Least-squares (reference src/families.h:64-127).  L = 1.0."""

    name = "gaussian"
    L_scaling = 1.0

    def __init__(self, n_classes: int = 1):
        super().__init__(1)

    def encode(self, y_raw):
        y = np.asarray(y_raw, dtype=np.float64)
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        if y.shape[1] != 1:
            raise ValueError("response for Gaussian regression must be one-dimensional.")
        return y, None

    def preprocess(self, y, weights=None):
        if weights is None:
            center = column_mean(y)
            scale = column_sd(y, center)
        else:
            center, scale = _wstats(y, weights)
        return (y - center) / scale, center, scale

    def loss(self, lp, y):
        r = lp[:, 0] - y[:, 0]
        return 0.5 * r * r

    def gradient(self, lp, y):
        return lp - y

    def null_intercept(self, y, fit_intercept, weights=None):
        return _wmean(y, weights)

    def lambda_max(self, x, y, y_scale, weights=None, col_mult=None):
        # y here is the standardized response (reference src/families.h:119-126)
        if weights is None:
            W = y.shape[0]
            inner = _xty(x, y)
        else:
            W = jnp.maximum(jnp.sum(weights), 1e-12)
            inner = _xty(x, y * weights.reshape(-1, 1))
        return y_scale[0] * jnp.max(jnp.abs(_apply_col_mult(inner, col_mult))) / W


class Binomial(Family):
    """Logistic regression, responses in {0, 1}
    (reference src/families.h:129-221).  L = 0.25."""

    name = "binomial"
    L_scaling = 0.25
    is_classification = True
    #: clamp for the logit link (reference src/families.h:142-150)
    P_MIN = 1e-9

    def __init__(self, n_classes: int = 1):
        super().__init__(1)

    def encode(self, y_raw):
        y = np.asarray(y_raw)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        classes, codes = np.unique(y, return_inverse=True)
        if len(classes) > 2:
            raise ValueError("more than two classes in response. Are you looking for family = 'multinomial'?")
        if len(classes) == 1:
            raise ValueError("only one class in response.")
        counts = np.bincount(codes)
        if counts.min() <= 1:
            raise ValueError(f"one class only has {counts.min()} observations.")
        return codes.astype(np.float64).reshape(-1, 1), [str(c) for c in classes]

    def link(self, p):
        z = clamp(p, self.P_MIN, 1.0 - self.P_MIN)
        return jnp.log(z / (1.0 - z))

    def loss(self, lp, y):
        z = lp[:, 0]
        # log(1 + exp(z)) - y*z, stable via logaddexp
        return jnp.logaddexp(0.0, z) - y[:, 0] * z

    def gradient(self, lp, y):
        return 1.0 / (1.0 + jnp.exp(-lp)) - y

    def null_intercept(self, y, fit_intercept, weights=None):
        if not fit_intercept:
            return jnp.zeros((1,), y.dtype)
        return self.link(_wmean(y, weights))

    def null_intercept_offset(self, y, offs, fit_intercept, weights=None):
        # Bisection on the strictly increasing 1-D function
        # f(b) = sum w*(sigma(b + o) - y): divergence-proof for any offset
        # magnitude (Newton overshoots once sigma saturates).  The root lies
        # within link(p_min/max) shifted by the offset range.
        if not fit_intercept:
            return jnp.zeros((1,), y.dtype)
        w = jnp.ones((y.shape[0], 1), y.dtype) if weights is None else weights.reshape(-1, 1)
        span = jnp.max(jnp.abs(offs)) + 35.0  # |link| <= ~21 at P_MIN=1e-9
        lo = jnp.full((1,), -span, y.dtype)
        hi = jnp.full((1,), span, y.dtype)

        def f(b):
            p = 1.0 / (1.0 + jnp.exp(-(b[None, :] + offs)))
            return jnp.sum(w * (p - y))

        def body(carry, _):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            go_right = f(mid) < 0.0
            return (jnp.where(go_right, mid, lo), jnp.where(go_right, hi, mid)), None

        (lo, hi), _ = jax.lax.scan(body, (lo, hi), None, length=80)
        return 0.5 * (lo + hi)

    def lambda_max(self, x, y, y_scale, weights=None, col_mult=None):
        # standardize the 0/1 response, then y_std * max|x^T y_map| / n
        # (reference src/families.h:203-220)
        if weights is None:
            W = y.shape[0]
            y_bar = column_mean(y)
            y_std = column_sd(y, y_bar)
            y_map = (y - y_bar) / y_std
        else:
            W = jnp.maximum(jnp.sum(weights), 1e-12)
            y_bar, y_std = _wstats(y, weights)
            y_map = (y - y_bar) / y_std * weights.reshape(-1, 1)
        inner = _apply_col_mult(_xty(x, y_map), col_mult)
        return y_std[0] * jnp.max(jnp.abs(inner)) / W


class Poisson(Family):
    """Log-link Poisson regression for count responses (extension: the
    reference has no Poisson family; glmnet does, and count models with
    log-exposure offsets are its canonical use).

    The Poisson negative log-likelihood has no *global* smoothness constant
    (d2/dlp2 = exp(lp) is unbounded), so SAGA's fixed step size needs a
    data-dependent curvature bound: `smoothness` caps the per-sample rate
    mu = exp(lp) — the linear predictor is clamped at log(smoothness)
    inside the exp, making the gradient Lipschitz with constant
    `smoothness` exactly, and `fit()` sets it from the response scale
    (~2x the max count, rounded to a power of two so jit retraces are
    bounded).  Near the optimum mu is on the scale of y, so the clamp is
    inactive where it matters; it only tames early iterates.

    The loss includes the saturated-model terms (y log y - y), so
    deviance = 2*sum(loss) is the true Poisson deviance and dev_ratio
    matches glmnet's definition.
    """

    name = "poisson"
    L_scaling = 1.0  # overridden per-fit via `smoothness`

    def __init__(self, n_classes: int = 1, smoothness: float = 1.0):
        super().__init__(1)
        self.smoothness = float(smoothness)
        self.L_scaling = self.smoothness

    def __hash__(self):
        return hash((type(self).__name__, self.n_classes, self.smoothness))

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.n_classes == other.n_classes
            and self.smoothness == other.smoothness
        )

    def encode(self, y_raw):
        y = np.asarray(y_raw, dtype=np.float64)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        if y.ndim != 1:
            raise ValueError("poisson response must be a vector")
        if (y < 0).any():
            raise ValueError("negative values not allowed for the 'poisson' family")
        return y.reshape(-1, 1), None

    def _mu(self, lp):
        # clamp INSIDE the exp: rates capped at the smoothness bound, which
        # is precisely what makes the fixed SAGA step size valid
        return jnp.exp(jnp.minimum(lp, jnp.log(self.smoothness)))

    def loss(self, lp, y):
        mu_log = jnp.minimum(lp[:, 0], jnp.log(self.smoothness))
        yv = y[:, 0]
        # mu - y*log(mu) + y*log(y) - y  (== half the unit deviance)
        ylogy = jnp.where(yv > 0, yv * jnp.log(jnp.maximum(yv, 1e-300)), 0.0)
        return jnp.exp(mu_log) - yv * mu_log + ylogy - yv

    def loss_report(self, lp, y):
        """Exact (unclamped) Poisson deviance terms: the smoothness clamp is
        a solver step-size device, not part of the model, so reported
        deviance/dev_ratio must not inherit it."""
        mu_log = lp[:, 0]
        yv = y[:, 0]
        ylogy = jnp.where(yv > 0, yv * jnp.log(jnp.maximum(yv, 1e-300)), 0.0)
        return jnp.exp(mu_log) - yv * mu_log + ylogy - yv

    def gradient(self, lp, y):
        return self._mu(lp) - y

    def null_intercept(self, y, fit_intercept, weights=None):
        if not fit_intercept:
            return jnp.zeros((1,), y.dtype)
        return jnp.log(jnp.maximum(_wmean(y, weights), 1e-10))

    def null_intercept_offset(self, y, offs, fit_intercept, weights=None):
        # closed form: sum w*(exp(b + o) - y) = 0  =>  b = log(swy / swe)
        if not fit_intercept:
            return jnp.zeros((1,), y.dtype)
        w = jnp.ones((y.shape[0], 1), y.dtype) if weights is None else weights.reshape(-1, 1)
        swy = jnp.sum(w * y)
        swe = jnp.sum(w * jnp.exp(offs))
        return jnp.log(jnp.maximum(swy, 1e-10) / jnp.maximum(swe, 1e-300)).reshape(1)

    def lambda_max(self, x, y, y_scale, weights=None, col_mult=None):
        # max-norm of the null-model gradient x^T (mu0 - y), mu0 = weighted
        # mean of y (same structure as the other families' null gradients)
        if weights is None:
            W = y.shape[0]
            resid = _wmean(y, None)[None, :] - y
        else:
            W = jnp.maximum(jnp.sum(weights), 1e-12)
            resid = (_wmean(y, weights)[None, :] - y) * weights.reshape(-1, 1)
        inner = _apply_col_mult(_xty(x, resid), col_mult)
        return jnp.max(jnp.abs(inner)) / W


class Multinomial(Family):
    """Softmax regression over K classes, one-hot response
    (reference src/families.h:223-329).  L = 0.25."""

    name = "multinomial"
    L_scaling = 0.25
    is_classification = True

    def encode(self, y_raw):
        y = np.asarray(y_raw)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        classes, codes = np.unique(y, return_inverse=True)
        k = len(classes)
        if k == 2:
            raise ValueError("only two classes in response. Are you looking for family = 'binomial'?")
        if k == 1:
            raise ValueError("only one class in response.")
        counts = np.bincount(codes)
        if counts.min() <= 1:
            raise ValueError(f"one class only has {counts.min()} observations.")
        if self.n_classes not in (1, k):
            raise ValueError(f"expected {self.n_classes} classes, found {k}")
        self.n_classes = k
        onehot = np.eye(k, dtype=np.float64)[codes]
        return onehot, [str(c) for c in classes]

    def loss(self, lp, y):
        return logsumexp(lp, axis=1) - jnp.sum(lp * y, axis=1)

    def gradient(self, lp, y):
        return jnp.exp(lp - logsumexp(lp, axis=1, keepdims=True)) - y

    def null_intercept(self, y, fit_intercept, weights=None):
        if fit_intercept:
            prop = _wmean(y, weights)
        else:
            prop = jnp.full((self.n_classes,), 1.0 / self.n_classes, dtype=y.dtype)
        log_prop = jnp.log(prop)
        return log_prop - jnp.mean(log_prop)

    def null_intercept_offset(self, y, offs, fit_intercept, weights=None):
        # IPF-style fixed point: match weighted class proportions under
        # softmax(b + o); converges linearly, then re-centered to sum 0
        if not fit_intercept:
            return jnp.zeros((self.n_classes,), y.dtype)
        target = jnp.maximum(_wmean(y, weights), 1e-12)
        w = jnp.ones((y.shape[0], 1), y.dtype) if weights is None else weights.reshape(-1, 1)
        W = jnp.maximum(jnp.sum(w), 1e-12)
        b0 = self.null_intercept(y, fit_intercept, weights)

        def body(b, _):
            lp = b[None, :] + offs
            p = jnp.exp(lp - logsumexp(lp, axis=1, keepdims=True))
            pw = jnp.maximum(jnp.sum(p * w, axis=0) / W, 1e-12)
            return b + jnp.log(target) - jnp.log(pw), None

        b, _ = jax.lax.scan(body, b0, None, length=100)
        return b - jnp.mean(b)

    def lambda_max(self, x, y, y_scale, weights=None, col_mult=None):
        # one-hot indicator standardized per class; per-class inner products
        # rescaled by that class's SD (reference src/families.h:300-325)
        if weights is None:
            W = y.shape[0]
            y_bar = column_mean(y)
            y_std = column_sd(y, y_bar)
            y_map = (y - y_bar) / y_std
        else:
            W = jnp.maximum(jnp.sum(weights), 1e-12)
            y_bar, y_std = _wstats(y, weights)
            y_map = (y - y_bar) / y_std * weights.reshape(-1, 1)
        inner = _apply_col_mult(_xty(x, y_map) * y_std, col_mult)
        return jnp.max(jnp.abs(inner)) / W


class MultivariateGaussian(Family):
    """Multi-response least squares (reference src/families.h:331-410).  L = 1.0."""

    name = "mgaussian"
    L_scaling = 1.0

    def __init__(self, n_classes: int = 1, standardize_response: bool = False):
        super().__init__(n_classes)
        self.standardize_response = standardize_response

    def encode(self, y_raw):
        y = np.asarray(y_raw, dtype=np.float64)
        if y.ndim != 2 or y.shape[1] == 1:
            raise ValueError(
                "response for multivariate Gaussian regression must not be "
                "one-dimensional; try family = 'gaussian'."
            )
        self.n_classes = y.shape[1]
        return y, None

    def preprocess(self, y, weights=None):
        # glmnet-style: standardizes y but reports coefficients on the
        # standardized-y scale (y_center/y_scale stay 0/1 — reference
        # src/families.h:337-348 deliberately never fills them in)
        k = self.n_classes
        if self.standardize_response:
            if weights is None:
                center = column_mean(y)
                scale = column_sd(y, center)
            else:
                center, scale = _wstats(y, weights)
            y = (y - center) / scale
        z = jnp.zeros((k,), y.dtype)
        return y, z, z + 1.0

    def loss(self, lp, y):
        return 0.5 * jnp.sum((lp - y) ** 2, axis=1)

    def gradient(self, lp, y):
        return lp - y

    def null_intercept(self, y, fit_intercept, weights=None):
        return _wmean(y, weights)

    def lambda_max(self, x, y, y_scale, weights=None, col_mult=None):
        # per-class standardized inner products, rescaled, then the max
        # per-feature L2 norm over classes (reference src/families.h:387-406);
        # col_mult (>= 0) commutes with the class norm, so it applies to inner
        if weights is None:
            n = y.shape[0]
            y_bar = column_mean(y)
            y_std = column_sd(y, y_bar)
            y_map = (y - y_bar) / y_std
            inner = _apply_col_mult(_xty(x, y_map) * (y_scale * y_std), col_mult)
            return jnp.max(jnp.sqrt(jnp.sum(inner**2, axis=1))) / n
        W = jnp.maximum(jnp.sum(weights), 1e-12)
        y_bar, y_std = _wstats(y, weights)
        y_map = (y - y_bar) / y_std * weights.reshape(-1, 1)
        inner = _apply_col_mult(_xty(x, y_map) * (y_scale * y_std), col_mult)
        return jnp.max(jnp.sqrt(jnp.sum(inner**2, axis=1))) / W


_FAMILIES = {
    "gaussian": Gaussian,
    "binomial": Binomial,
    "poisson": Poisson,
    "multinomial": Multinomial,
    "mgaussian": MultivariateGaussian,
}


def get_family(name: str, n_classes: int = 1, standardize_response: bool = False, smoothness: float = 1.0) -> Family:
    """Family factory (reference src/sgdnet.cpp:298-335; poisson is an
    extension — `smoothness` is its per-sample curvature bound)."""
    if name not in _FAMILIES:
        raise ValueError(f"unknown family '{name}'; choose from {sorted(_FAMILIES)}")
    if name == "mgaussian":
        return MultivariateGaussian(n_classes, standardize_response)
    if name == "poisson":
        return Poisson(1, smoothness)
    return _FAMILIES[name](n_classes)
