"""Test configuration: force the CPU backend (8 virtual devices for
multi-device sharding tests) and enable float64 so closed-form oracle
comparisons are meaningful.  The platform is set through jax.config before
first use, so the suite runs on the CPU even where a GPU is present.  Tests
that need the GPU carry the `gpu` marker and take the `gpu_env` fixture,
which runs them in a child process on the GPU and skips them without one."""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# no persistent compile cache for the suite: importing sgdnet_tpu points
# one at the checkout, and the suite's CPU executables have no use there
jax.config.update("jax_enable_compilation_cache", False)
# serialize CPU dispatch: long xdist workers accumulate hundreds of live
# executables, and async dispatch overlapping XLA *compilation* of the next
# test's program intermittently segfaulted workers inside
# backend_compile_and_load (observed 2026-08-21, 2-3 crashes across three
# full runs, always mid-compile, never reproducible standalone).  Tests
# measure correctness, not dispatch latency — determinism wins here.
jax.config.update("jax_cpu_enable_async_dispatch", False)

import pytest  # noqa: E402

_TEST_COUNT = 0


@pytest.fixture(scope="session")
def gpu_env():
    """Environment for a child process on the GPU (this process is pinned
    to the CPU above); skips the test where JAX finds no GPU.  Decided
    here, at run time, never while a module is imported."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    if r.returncode != 0 or r.stdout.split()[-1:] != ["gpu"]:
        pytest.skip("needs a GPU (run `python -m pytest tests -m gpu` on a GPU host)")
    return env


@pytest.fixture(autouse=True)
def _bound_live_executables():
    """Clear jax's executable caches every 30 tests: the segfaults above
    struck only deep into a worker's life (hundreds of live compiled
    programs), never in short runs of the same tests — bounding the live
    set removes the trigger at the cost of some same-shape recompiles."""
    global _TEST_COUNT
    yield
    _TEST_COUNT += 1
    if _TEST_COUNT % 30 == 0:
        jax.clear_caches()
