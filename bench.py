"""Benchmark: sparse-CSR binomial SAGA epoch throughput (nnz/s) on the GPU.

The north-star metric from BASELINE.md: nonzeros processed per second in
SAGA epochs on an rcv1-scale synthetic sparse binomial workload (n=100k,
p=47k, 76 nnz/row, Zipf column popularity).  The reference publishes no
absolute numbers (BASELINE.md — relative curves only, single-threaded C++).

    python bench.py

Fails unless JAX's default platform is the GPU.  Prints the platform,
device kind, device count and the cards' power limits first, the per-config
results on stderr, and one JSON line at the end:
  {"metric": "sparse_saga_nnz_per_s", "value": ..., "unit": "nnz/s",
   "vs_baseline": ..., "device": {...}}
`value` is the best of the sparse configs; every config must run, and any
failure ends the run with a non-zero exit.  `vs_baseline` divides by a
FROZEN single-core CPU baseline (protocol pinned in BASELINE.md): sklearn's
Cython SAGA at 4.50e5 nnz/s on this workload.  Every timing ends in
`block_until_ready`.
"""

import json
import subprocess
import sys
import time

import numpy as np

# FROZEN baseline (see module docstring + BASELINE.md): sklearn Cython SAGA,
# single core, 3 epochs on the full n=100k/p=47k/7.6M-nnz workload.
CPU_BASELINE_NNZ_PER_S = 4.50e5

T0 = time.monotonic()


def log(*a):
    print(f"[{time.monotonic() - T0:6.1f}s]", *a, file=sys.stderr, flush=True)


def require_gpu():
    """(platform, device_kind, count) of JAX's devices; raises unless the
    default platform is the GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default platform is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this measurement runs on the GPU only"
        )
    return devs[0].platform, devs[0].device_kind, len(devs)


def parse_gpu_info(text: str) -> list[tuple[str, str]]:
    """(name, power limit) per card from the output of
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    out = []
    for line in text.splitlines():
        if line.strip():
            name, limit = line.rsplit(",", 1)
            out.append((name.strip(), limit.strip()))
    if not out:
        raise ValueError("nvidia-smi reported no GPU")
    return out


def gpu_info() -> list[tuple[str, str]]:
    """The cards' names and power limits, read by nvidia-smi in a child
    process (it never touches JAX or the card's memory)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return parse_gpu_info(r.stdout)


def to_scipy(csr_np):
    """numpy padded-CSR dict -> scipy csr."""
    import scipy.sparse as sp

    n, p = csr_np["n"], csr_np["p"]
    ind = csr_np["indices"].reshape(-1)
    val = csr_np["values"].reshape(-1)
    rows = np.repeat(np.arange(n), csr_np["indices"].shape[1])
    keep = val != 0
    return sp.csr_matrix((val[keep], (rows[keep], ind[keep])), shape=(n, p))


def make_sparse_binomial(n=100_000, p=47_000, nnz_per_row=76, seed=0, dtype=np.float32):
    """rcv1-scale synthetic: fixed nnz per row, Zipf-like column usage
    (bag-of-words statistics: a small head of frequent features carries most
    nonzeros, like the real rcv1).  Returns a numpy padded-CSR dict — build
    device layouts via `as_padded` / `build_hybrid_device`."""
    rng = np.random.default_rng(seed)
    # Zipf column popularity ~ (rank + 10)^-1.15 — bag-of-words-like skew
    # (real rcv1: a few thousand hot features carry most term occurrences)
    weights = (np.arange(p) + 10.0) ** -1.15
    cdf = np.cumsum(weights) / weights.sum()
    cols = np.searchsorted(cdf, rng.random((n, nnz_per_row))).astype(np.int32).clip(0, p - 1)
    vals = rng.normal(size=(n, nnz_per_row)).astype(dtype)
    w_true = rng.normal(size=p) * (rng.random(p) < 0.05) * 3.0
    lp = (vals * w_true[cols]).sum(axis=1)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-lp))).astype(dtype)

    L = ((nnz_per_row + 7) // 8) * 8
    indices = np.zeros((n, L), np.int32)
    values = np.zeros((n, L), dtype)
    indices[:, :nnz_per_row] = cols
    values[:, :nnz_per_row] = vals
    x = dict(indices=indices, values=values, nnz=np.full((n,), nnz_per_row, np.int32), n=n, p=p)
    return x, y.reshape(-1, 1)


def as_padded(csr_np):
    """numpy padded-CSR dict -> device PaddedCSR."""
    import jax.numpy as jnp

    from sgdnet_tpu.core.sparse import PaddedCSR

    return PaddedCSR(
        jnp.asarray(csr_np["indices"]),
        jnp.asarray(csr_np["values"]),
        jnp.asarray(csr_np["nnz"]),
        csr_np["n"],
        csr_np["p"],
    )


def build_hybrid_device(csr_np, n_pad, max_head=4096, coverage=0.9, head_dtype=None,
                        batch_size=None):
    """Device HybridCSR for the bench configs: split and pad host-side,
    pack the BlockCOO tail host-side (block sampling), and for int8 heads
    upload only the quantized nonzeros and build the dense block on device
    (materialize_int8_head)."""
    import jax
    import jax.numpy as jnp

    from sgdnet_tpu.core.sparse import BlockCOO, HybridCSR, PaddedCSR, materialize_int8_head

    t0 = time.monotonic()
    xs = to_scipy(csr_np)
    quant_int8 = head_dtype is not None and jnp.dtype(head_dtype) == jnp.int8
    xh, perm = HybridCSR.split_columns(
        xs, coverage=coverage, max_head=max_head, head_dtype=head_dtype, as_host=True,
        head_form="nnz" if quant_int8 else "dense",
    )
    col_nnz = np.bincount(xs.indices, minlength=csr_np["p"])
    head_nnz = int(col_nnz[perm[: xh.n_head]].sum())
    log(
        f"hybrid split in {time.monotonic() - t0:.1f}s: head D={xh.n_head} covers "
        f"{head_nnz / max(xs.nnz, 1):.1%} of nnz, tail width L={xh.tail.row_width}"
    )

    extra = n_pad - xh.n_rows
    L = xh.tail.row_width
    ti = np.concatenate([xh.tail.indices, np.zeros((extra, L), np.int32)])
    tv = np.concatenate([xh.tail.values, np.zeros((extra, L), xh.tail.values.dtype)])
    tz = np.concatenate([xh.tail.nnz, np.zeros((extra,), np.int32)])
    blk = None
    if batch_size is not None:
        blk = BlockCOO.from_padded(PaddedCSR(ti, tv, tz, n_pad, csr_np["p"]), batch_size)

    t1 = time.monotonic()
    if quant_int8:
        head_dev = materialize_int8_head(xh.head, n_pad=n_pad)
    else:
        head_dev = jax.device_put(
            np.concatenate([xh.head, np.zeros((extra, xh.n_head), xh.head.dtype)])
        )
    jax.block_until_ready(head_dev)
    log(f"head D={xh.n_head} {head_dev.dtype} on device in {time.monotonic() - t1:.1f}s")

    tail_dev = PaddedCSR(jnp.asarray(ti), jnp.asarray(tv), jnp.asarray(tz), n_pad, csr_np["p"])
    scale_dev = None if xh.head_scale is None else jnp.asarray(xh.head_scale)
    return HybridCSR(head_dev, tail_dev, n_pad, csr_np["p"], blk_tail=blk, head_scale=scale_dev)


def bench_sparse_epoch(
    n=100_000,
    p=47_000,
    nnz_per_row=76,
    batch_size=1024,
    epochs=5,
    sparse_mode="gather",
    hybrid=False,
    scan_unroll=1,
    max_head=4096,
    coverage=0.9,
    sampling="permutation",
    g_sum_refresh_every=1,
    head_dtype=None,
    data=None,
):
    import jax
    import jax.numpy as jnp

    from sgdnet_tpu.families import get_family
    from sgdnet_tpu.penalties import select_penalty
    from sgdnet_tpu.solver.saga import SolverConfig, _make_epoch, init_state

    csr_np, y = data if data is not None else make_sparse_binomial(n, p, nnz_per_row)
    n_pad = ((n + batch_size - 1) // batch_size) * batch_size
    if hybrid:
        x = build_hybrid_device(
            csr_np, n_pad, max_head=max_head, coverage=coverage, head_dtype=head_dtype,
            batch_size=batch_size if sampling == "block" else None,
        )
    else:
        x = as_padded(csr_np).pad_rows(n_pad)
    y = jnp.concatenate([jnp.asarray(y), jnp.zeros((n_pad - n, 1), jnp.float32)])
    weights = jnp.concatenate([jnp.ones((n,), jnp.float32), jnp.zeros((n_pad - n,), jnp.float32)])

    family = get_family("binomial")
    penalty = select_penalty(1.0, "binomial")
    config = SolverConfig(
        batch_size=batch_size,
        fit_intercept=True,
        sparse_mode=sparse_mode,
        intercept_decay=0.01,
        scan_unroll=scan_unroll,
        sampling=sampling,
        g_sum_refresh_every=g_sum_refresh_every,
    )
    state = init_state(n_pad, p, 1, jnp.float32)

    lam = 1.0 / n  # the reference benchmark protocol's lambda (BASELINE.md)
    gamma, l1, l2 = jnp.float32(3e-3), jnp.float32(lam), jnp.float32(0.0)

    from functools import partial

    # x/y/weights must be jit ARGUMENTS (not closure captures), else they are
    # embedded as program constants and blow up compilation
    @partial(jax.jit, static_argnames=("family", "penalty", "config", "epochs"))
    def run_epochs(x, y, weights, state, key, family, penalty, config, epochs):
        epoch = _make_epoch(x, y, weights, None, jnp.float32(n), family, penalty, config)

        def body(state, i):
            return epoch(state, jax.random.fold_in(key, i), gamma, l1, l2, it=i), None

        state, _ = jax.lax.scan(body, state, jnp.arange(epochs))
        return state

    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    state = jax.block_until_ready(
        run_epochs(x, y, weights, state, key, family, penalty, config, epochs)
    )
    log(f"compile+first run: {time.perf_counter() - t0:.2f}s")

    elapsed_run = float("inf")
    for r in range(1, 4):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run_epochs(
            x, y, weights, state, jax.random.fold_in(key, r), family, penalty, config, epochs
        ))
        elapsed_run = min(elapsed_run, time.perf_counter() - t0)
    if not bool(jnp.all(jnp.isfinite(state.w))):
        raise FloatingPointError("non-finite coefficients after the timed epochs")

    total_nnz = n * nnz_per_row * epochs
    nnz_per_s = total_nnz / elapsed_run
    log(
        f"sparse epoch bench: n={n} p={p} nnz/row={nnz_per_row} B={batch_size} "
        f"mode={'hybrid' if hybrid else sparse_mode}"
        f"{'+block' if sampling == 'block' else ''}"
        f"{f'+refresh/{g_sum_refresh_every}' if g_sum_refresh_every > 1 else ''}"
        f"{f'+head:{jnp.dtype(head_dtype).name}' if head_dtype is not None else ''}: "
        f"{epochs} epochs in {elapsed_run:.4f}s -> {nnz_per_s:.4e} nnz/s"
    )
    return nnz_per_s


def bench_dense_multinomial(
    n=65536, p=784, k=10, batch_size=4096, epochs=3, matmul_precision="highest",
    label="dense multinomial",
):
    """Secondary: dense multinomial epoch throughput (matmul-bound path).

    The default shape is the reference-scale workload; `main()` also runs a
    larger shape (n=131072, p=8192, k=64) at BOTH matmul precisions:
    "default" (the backend's fast float32 mode) and "highest" (the solver's
    actual default)."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from sgdnet_tpu.families import get_family
    from sgdnet_tpu.penalties import select_penalty
    from sgdnet_tpu.solver.saga import SolverConfig, _make_epoch, init_state

    # generated on device: the values don't matter for throughput
    key = jax.random.PRNGKey(0)
    x = jax.jit(lambda kk: jax.random.normal(kk, (n, p), jnp.float32))(key)
    yi = jax.random.randint(jax.random.fold_in(key, 1), (n,), 0, k)
    y = jax.nn.one_hot(yi, k, dtype=jnp.float32)
    weights = jnp.ones((n,), jnp.float32)

    family = get_family("multinomial", n_classes=k)
    penalty = select_penalty(1.0, "multinomial")
    config = SolverConfig(
        batch_size=batch_size, fit_intercept=True, matmul_precision=matmul_precision,
        sampling="block",
    )
    state = init_state(n, p, k, jnp.float32)

    @partial(jax.jit, static_argnames=("family", "penalty", "config", "epochs"))
    def run(x, y, weights, state, key, family, penalty, config, epochs):
        with jax.default_matmul_precision(config.matmul_precision):
            epoch = _make_epoch(x, y, weights, None, jnp.float32(n), family, penalty, config)

            def body(state, i):
                return epoch(state, jax.random.fold_in(key, i), jnp.float32(1e-3), jnp.float32(1e-4), jnp.float32(0.0)), None

            return jax.lax.scan(body, state, jnp.arange(epochs))[0]

    state = jax.block_until_ready(run(x, y, weights, state, key, family, penalty, config, epochs))
    dt = float("inf")
    for r in range(1, 4):
        t0 = time.perf_counter()
        jax.block_until_ready(
            run(x, y, weights, state, jax.random.fold_in(key, r), family, penalty, config, epochs)
        )
        dt = min(dt, time.perf_counter() - t0)
    flops = 4 * n * p * k * epochs  # fwd + bwd matmuls, 2 flops/MAC
    log(
        f"{label} bench: n={n} p={p} k={k} B={batch_size} prec={matmul_precision}: "
        f"{epochs} epochs in {dt:.4f}s -> {n * epochs / dt:.4e} samples/s, "
        f"{flops / dt / 1e12:.3f} TFLOP/s"
    )
    return n * epochs / dt


def main():
    import jax.numpy as jnp

    platform, kind, count = require_gpu()
    cards = gpu_info()
    log(f"platform {platform}, device_kind {kind!r}, count {count}")
    for name, limit in cards:
        log(f"card: {name}, power limit {limit}")

    data = make_sparse_binomial()
    # int8 hybrid-head configs; `epochs` is the refresh period so the g_sum
    # refresh is sampled at its amortized rate
    sparse_configs = [
        dict(batch_size=8192, hybrid=True, max_head=32768, coverage=0.995,
             sampling="block", g_sum_refresh_every=8, head_dtype=jnp.int8, epochs=8),
        dict(batch_size=8192, hybrid=True, max_head=24576, coverage=0.99,
             sampling="block", g_sum_refresh_every=8, head_dtype=jnp.int8, epochs=8),
    ]
    best = max(bench_sparse_epoch(**kw, data=data) for kw in sparse_configs)

    bench_dense_multinomial(n=131072, p=8192, k=64, batch_size=8192, epochs=3,
                            matmul_precision="default", label="dense multinomial")
    bench_dense_multinomial(n=131072, p=8192, k=64, batch_size=8192, epochs=3,
                            matmul_precision="highest", label="dense multinomial (f32)")
    bench_dense_multinomial()

    print(json.dumps({
        "metric": "sparse_saga_nnz_per_s",
        "value": best,
        "unit": "nnz/s",
        "vs_baseline": best / CPU_BASELINE_NNZ_PER_S,
        "device": {"platform": platform, "kind": kind, "count": count,
                   "power_limit": cards[0][1]},
    }), flush=True)


if __name__ == "__main__":
    main()
