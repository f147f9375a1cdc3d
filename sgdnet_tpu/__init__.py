"""sgdnet_tpu — elastic-net GLMs via batched SAGA on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of the reference R
package `sgdnet` (elastic-net regularized gaussian, binomial, multinomial
and multivariate-gaussian GLMs fitted with the SAGA incremental-gradient
algorithm over a warm-started lambda path): minibatch matmul-shaped
updates, padded-CSR sparse support, and mesh-sharded multi-device
execution.  Runs on the GPU (the target) and on the CPU backend.

Importing the package gives JAX a persistent compile cache, so the
whole-path program compiles once per shape and machine rather than once
per process (see `compile_cache_dir`).
"""

import os

import jax

#: the package's default compile-cache directory: fixed, inside the
#: checkout (JAX keys cache entries on the path, so it must not move)
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir(environ=os.environ) -> str:
    """Directory of JAX's persistent compile cache for this package:
    `JAX_COMPILATION_CACHE_DIR` when set (JAX reads the variable itself),
    else `REPO_CACHE_DIR`."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


if not jax.config.jax_compilation_cache_dir:
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from sgdnet_tpu.api.fit import SgdnetFit, fit
from sgdnet_tpu.api.predict import predict
from sgdnet_tpu.api.score import score
from sgdnet_tpu.core.layout import LayoutPlan, plan_layout
from sgdnet_tpu.core.sparse import PaddedCSR

__version__ = "0.1.0"

__all__ = [
    "fit", "predict", "score", "SgdnetFit", "PaddedCSR", "cv_fit",
    "plan_layout", "LayoutPlan", "compile_cache_dir",
]


def cv_fit(*args, **kwargs):
    from sgdnet_tpu.api.cv import cv_fit as _cv_fit

    return _cv_fit(*args, **kwargs)
