"""Penalty (regularizer) objects.

Accelerator re-design of the reference's per-feature penalty functors
(reference src/penalties.h:27-79).  The reference fuses the gradient-average
step with the prox one feature-column at a time inside the sequential inner
loop; here a penalty is a *whole-matrix* proximal operator applied once per
batched SAGA step:

    w  <-  prox_{gamma * l1}( w * (1 - gamma * l2)  -  gamma * grad_est )

which has the same fixed point as the reference's per-sample update chain
(see solver/saga.py for the argument).  Naming: the reference's internal
`alpha` is the L2 strength and `beta` the L1 strength, with the member
comments swapped (reference src/penalties.h:22-24) — we use the unambiguous
`l2` / `l1` throughout.
"""

from __future__ import annotations

import jax.numpy as jnp

from sgdnet_tpu.core.linalg import soft_threshold


class Penalty:
    """Base: pure L2 handled by the (1 - gamma*l2) decay in the solver."""

    name = "base"

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return type(self) is type(other)

    def prox(self, w: jnp.ndarray, threshold) -> jnp.ndarray:
        """Proximal operator of the non-smooth part; w is (k, p)."""
        raise NotImplementedError

    def value(self, w: jnp.ndarray, pf=None):
        """The non-smooth objective term P1(w) (without its l1 multiplier),
        with optional (p,) per-feature penalty factors — used by the
        solver's step-backoff to compare attempts on the PENALIZED
        objective (deviance alone would prefer under-shrunk iterates)."""
        raise NotImplementedError


class Ridge(Penalty):
    """Pure L2: identity prox (reference src/penalties.h:27-39)."""

    name = "ridge"

    def prox(self, w, threshold):
        return w

    def value(self, w, pf=None):
        return jnp.zeros((), w.dtype)


class ElasticNet(Penalty):
    """Elementwise soft-thresholding (reference src/penalties.h:41-59)."""

    name = "elastic_net"

    def prox(self, w, threshold):
        return soft_threshold(w, threshold)

    def value(self, w, pf=None):
        a = jnp.abs(w)
        if pf is not None:
            a = a * pf
        return jnp.sum(a)


class GroupLasso(Penalty):
    """Feature-column group prox: each feature's coefficient vector across
    classes is L2-shrunk or zeroed (reference src/penalties.h:61-79)."""

    name = "group_lasso"

    def prox(self, w, threshold):
        norms = jnp.sqrt(jnp.sum(w * w, axis=0, keepdims=True))  # (1, p)
        factor = jnp.maximum(1.0 - threshold / jnp.maximum(norms, 1e-300), 0.0)
        return w * factor

    def value(self, w, pf=None):
        norms = jnp.sqrt(jnp.sum(w * w, axis=0))  # (p,)
        if pf is not None:
            norms = norms * pf
        return jnp.sum(norms)


def select_penalty(elasticnet_mix: float, family: str, type_multinomial: str = "ungrouped") -> Penalty:
    """Penalty selection rule (reference src/sgdnet.cpp:80-99): ridge when the
    mix is 0; group lasso for mgaussian and grouped multinomial; elastic net
    otherwise.  Unlike the reference R layer (which hardcodes 'ungrouped',
    reference R/sgdnet.R:265-272), grouped multinomial is reachable here."""
    if elasticnet_mix == 0.0:
        return Ridge()
    if family == "mgaussian" or (family == "multinomial" and type_multinomial == "grouped"):
        return GroupLasso()
    return ElasticNet()
