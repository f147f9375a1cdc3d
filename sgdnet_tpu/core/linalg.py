"""Core numeric kernels (pure jax.numpy, stateless).

Accelerator equivalents of the reference's scalar math helpers
(reference src/math.h:25-199): logsumexp, log-spaced sequences, column
mean/standard-deviation with the reference's population-SD and
zero-variance-guard semantics, standardization, clamping, and class
proportions.  Everything here is shape-polymorphic, jit-safe, and
vectorized over whole matrices instead of per-column loops.
"""

from __future__ import annotations

import jax.numpy as jnp


def logsumexp(x: jnp.ndarray, axis: int = -1, keepdims: bool = False) -> jnp.ndarray:
    """Numerically-stable log(sum(exp(x))) (reference src/math.h:25-33)."""
    x_max = jnp.max(x, axis=axis, keepdims=True)
    x_max = jnp.where(jnp.isfinite(x_max), x_max, 0.0)
    out = jnp.log(jnp.sum(jnp.exp(x - x_max), axis=axis, keepdims=True)) + x_max
    return out if keepdims else jnp.squeeze(out, axis=axis)


def logspace(start: float, stop: float, num: int) -> jnp.ndarray:
    """Log-spaced sequence from `start` down/up to `stop` inclusive
    (reference src/math.h:42-56)."""
    log_from = jnp.log(start)
    log_to = jnp.log(stop)
    return jnp.exp(jnp.linspace(log_from, log_to, num))


def column_mean(x: jnp.ndarray) -> jnp.ndarray:
    """Per-column arithmetic mean (reference src/math.h:66-79)."""
    return jnp.mean(x, axis=0)


def column_sd(x: jnp.ndarray, center: jnp.ndarray | None = None) -> jnp.ndarray:
    """Per-column population standard deviation with the reference's
    zero-variance guard: columns with var == 0 get SD 1.0 so that
    standardization is a no-op there (reference src/math.h:114-130)."""
    if center is None:
        center = column_mean(x)
    var = jnp.mean((x - center) ** 2, axis=0)
    return jnp.where(var == 0.0, 1.0, jnp.sqrt(var))


def standardize(x: jnp.ndarray, center: jnp.ndarray | None = None, scale: jnp.ndarray | None = None):
    """Center/scale columns; returns (x_std, center, scale)
    (reference src/math.h:139-160)."""
    if center is None:
        center = column_mean(x)
    if scale is None:
        scale = column_sd(x, center)
    return (x - center) / scale, center, scale


def clamp(x: jnp.ndarray, lo: float, hi: float) -> jnp.ndarray:
    """Clamp to [lo, hi] (reference src/math.h:167-172)."""
    return jnp.clip(x, lo, hi)


def proportions(y_codes: jnp.ndarray, n_classes: int) -> jnp.ndarray:
    """Class proportions from integer class codes (reference src/math.h:184-199)."""
    onehot = jnp.equal(y_codes.reshape(-1, 1), jnp.arange(n_classes).reshape(1, -1))
    return jnp.mean(onehot.astype(jnp.result_type(float)), axis=0)


def soft_threshold(x: jnp.ndarray, a) -> jnp.ndarray:
    """Elementwise soft-thresholding prox of the L1 norm
    (reference src/prox.h:32-39)."""
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - a, 0.0)
