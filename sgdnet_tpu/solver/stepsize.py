"""SAGA step sizes, serial and minibatch.

The reference's serial step size is gamma = 1 / (2L + min(L, 2n*l2)) with
L = (max_i ||x_i||^2 + fit_intercept) * L_scaling + l2
(reference src/utils.h:31-51).  That is calibrated for B = 1 sample per
update.  The batched solver takes B samples per step, and simply reusing the
serial gamma would move ~B times less per epoch.  We instead use the
expected-smoothness step size for minibatch SAGA (Gazagnadou, Gower &
Salmon, "Optimal mini-batch and step sizes for SAGA", 2019): the batch
Lipschitz constant interpolates between L_max (B = 1) and L_full (B = n),

    L_B = (n (B-1)) / (B (n-1)) * L_full  +  (n - B) / (B (n-1)) * L_max

and since L_full = lambda_max(X^T X) / n is typically far smaller than
L_max = max_i ||x_i||^2, large batches earn proportionally larger steps —
this is what lets the batched solver converge in a comparable number of
epochs while keeping each step matmul-shaped.  At B = 1 the formula degrades exactly to
the reference's.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from sgdnet_tpu.core.sparse import HybridCSR, PaddedCSR


def power_iteration_sq_norm(x, x_center_scaled=None, n_iter: int = 30, seed: int = 0):
    """lambda_max(X^T X) via power iteration; x dense (n, p), PaddedCSR, or
    HybridCSR.

    With `x_center_scaled` given (sparse standardized path), the operator is
    (X - 1 c^T), applied without densifying.

    Runs as ONE jitted program: the final Rayleigh-quotient matvec used to
    run eagerly, which materialized the dequantized f32 head of an int8
    hybrid (13 GB at bench scale) op by op — measured 12 s of fit()'s warm
    prologue; jitted, XLA fuses the int8 convert into the matmuls and the
    whole routine is a few head-stream passes (< 1 s).
    """
    return _power_iteration_jit(x, x_center_scaled, n_iter=n_iter, seed=seed)


@partial(jax.jit, static_argnames=("n_iter", "seed"))
def _power_iteration_jit(x, x_center_scaled, *, n_iter: int, seed: int):
    if isinstance(x, (PaddedCSR, HybridCSR)):
        p = x.n_cols
        dtype = x.values.dtype if isinstance(x, PaddedCSR) else x.head.dtype
        # a bf16 head must not drag the iteration vectors down to bf16
        dtype = jnp.promote_types(dtype, jnp.float32)

        def matvec(v):
            xv = x.matmul_dense(v.reshape(-1, 1).astype(dtype))[:, 0]
            if x_center_scaled is not None:
                xv = xv - jnp.dot(x_center_scaled.astype(xv.dtype), v.astype(xv.dtype))
            ytx = x.matvec_T(xv)
            if x_center_scaled is not None:
                ytx = ytx - jnp.sum(xv) * x_center_scaled.astype(xv.dtype)
            return ytx

    else:
        p = x.shape[1]
        dtype = x.dtype

        def matvec(v):
            xv = x @ v.astype(x.dtype)
            return x.T @ xv
    v = jax.random.normal(jax.random.PRNGKey(seed), (p,), dtype=dtype)
    v = v / jnp.linalg.norm(v)

    def body(_, v):
        w = matvec(v).astype(dtype)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, n_iter, body, v)
    w = matvec(v)
    return jnp.dot(w, v)  # Rayleigh quotient ~ top eigenvalue of X^T X


def saga_step_sizes(
    max_sq_norm,
    mean_sq_norm_top,  # lambda_max(X^T X) / n  (None -> fall back to max)
    l2_path: jnp.ndarray,  # per-lambda L2 strengths (the reference's `alpha`)
    n_samples,
    batch_size: int,
    fit_intercept: bool,
    L_scaling: float,
):
    """Per-lambda step sizes; serial formula at B = 1, minibatch otherwise."""
    fi = 1.0 if fit_intercept else 0.0
    # widest dtype actually available: f64 only when x64 is enabled (avoids
    # the jax truncation warning storm on an x64-disabled backend)
    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    n = jnp.asarray(n_samples, acc)
    B = float(batch_size)

    L_max = (max_sq_norm + fi) * L_scaling + l2_path
    if batch_size <= 1:
        mu_n = 2.0 * n * l2_path
        return 1.0 / (2.0 * L_max + jnp.minimum(L_max, mu_n))

    L_full = (jnp.asarray(mean_sq_norm_top, acc) + fi) * L_scaling + l2_path
    denom = jnp.maximum(B * (n - 1.0), 1.0)
    L_B = (n * (B - 1.0)) / denom * L_full + jnp.maximum(n - B, 0.0) / denom * L_max
    L_B = jnp.maximum(L_B, L_full)  # guard tiny-n edge cases
    mu_n = 2.0 * n * l2_path / B
    return 1.0 / (2.0 * L_B + jnp.minimum(L_B, mu_n))
