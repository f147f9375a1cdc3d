"""Padded-CSR sparse matrix containers.

The reference keeps features in an Eigen CSC/CSR sparse matrix and walks
per-sample nonzeros with scalar iterators (reference src/saga-sparse.h:90-130).
Compiled accelerator programs need static shapes, so a sparse design
matrix is stored as a
row-padded layout:

    indices : (n, L) int32   column index of each nonzero, 0-padded
    values  : (n, L) float   nonzero values, 0.0-padded
    nnz     : (n,)   int32   true nonzero count per row

where L = max row nnz (optionally rounded up to a lane multiple).  Padding
with value 0.0 makes padded entries mathematically inert in every gather/
scatter the solver performs, so no masking is needed on the compute path.

Column statistics reproduce the reference's sparse-aware population variance
(zeros counted, zero-variance columns get SD 1.0 — reference src/math.h:89-112)
without ever densifying, and standardization is scale-only in place with the
centering folded into a rank-1 correction term exactly as the reference does
(reference src/utils.h:110-121, src/saga-sparse.h:276-277).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def canonical_csr(x):
    """scipy CSR with sorted, duplicate-free column indices (duplicate
    entries summed), copying only when the input is not canonical already.
    Every layout built from it then has at most one entry per (row, col):
    the int8 head build scatters with `unique_indices=True`, and colliding
    writes of a scatter-set land in no fixed order on the GPU."""
    x = x.tocsr()
    if not x.has_canonical_format:
        x = x.copy()
        x.sum_duplicates()
    return x


@jax.tree_util.register_pytree_node_class
@dataclass
class PaddedCSR:
    """Row-padded CSR sparse matrix of logical shape (n_rows, n_cols)."""

    indices: jnp.ndarray  # (n, L) int32
    values: jnp.ndarray  # (n, L) float
    nnz: jnp.ndarray  # (n,) int32
    n_rows: int
    n_cols: int

    def tree_flatten(self):
        return (self.indices, self.values, self.nnz), (self.n_rows, self.n_cols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        indices, values, nnz = children
        return cls(indices, values, nnz, *aux)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def row_width(self) -> int:
        return self.indices.shape[1]

    @classmethod
    def from_dense(cls, x: np.ndarray, dtype=jnp.float32, lane_multiple: int = 8) -> "PaddedCSR":
        import scipy.sparse as sp

        return cls.from_scipy(sp.csr_matrix(np.asarray(x)), dtype=dtype, lane_multiple=lane_multiple)

    @classmethod
    def from_scipy(cls, x, dtype=jnp.float32, lane_multiple: int = 8) -> "PaddedCSR":
        """Build from a scipy CSR/CSC/COO matrix (host-side; uses the native
        multithreaded packer from utils/native.py when available)."""
        x = canonical_csr(x)
        n, p = x.shape
        nnz = np.diff(x.indptr).astype(np.int32)
        L = max(int(nnz.max()) if n else 0, 1)
        L = _round_up(L, lane_multiple)
        if dtype == jnp.float32:
            from sgdnet_tpu.utils.native import pack_padded

            indices, values, nnz = pack_padded(x, L)
        else:
            indices = np.zeros((n, L), dtype=np.int32)
            values = np.zeros((n, L), dtype=np.float64)
            rows = np.repeat(np.arange(n), nnz)
            pos = np.arange(len(x.data)) - np.repeat(x.indptr[:-1], nnz)
            indices[rows, pos] = x.indices
            values[rows, pos] = x.data
        return cls(
            indices=jnp.asarray(indices),
            values=jnp.asarray(values, dtype=dtype),
            nnz=jnp.asarray(nnz),
            n_rows=n,
            n_cols=p,
        )

    def total_nnz(self) -> int:
        if isinstance(self.nnz, np.ndarray):
            return int(self.nnz.sum())
        # reduce on device and read back one scalar, not the (n,) vector.
        # Accumulate in float, not int32: with x64 disabled (the GPU config)
        # an int32 sum silently wraps above ~2.1e9 total nnz; the float path
        # is exact with x64 and ~1e-7-relative otherwise (XLA tree-reduces),
        # which is fine for a stats counter.
        return int(jnp.sum(self.nnz.astype(jnp.float64)))

    def column_stats(self, weights=None):
        """Sparse-aware per-column (mean, population SD) counting implicit
        zeros; zero-variance columns get SD 1.0 (reference src/math.h:89-112).

        With `weights` (n,) given, the weighted mean/SD (sum w_i x_ij / W and
        sum w_i (x_ij - mean)^2 / W) — implicit zeros still counted, so only
        the nonzeros are touched: the weighted analog of the reference's
        sparse-aware variance."""
        n, p = self.shape
        flat_idx = self.indices.reshape(-1)
        flat_val = self.values.reshape(-1).astype(jnp.float64)
        if weights is None:
            w_flat = 1.0
            W = jnp.asarray(float(n), jnp.float64)
        else:
            w = weights.astype(jnp.float64)
            w_flat = jnp.repeat(w, self.row_width)
            W = jnp.maximum(jnp.sum(w), 1e-12)
        sums = jnp.zeros((p,), dtype=jnp.float64).at[flat_idx].add(w_flat * flat_val)
        sq_sums = jnp.zeros((p,), dtype=jnp.float64).at[flat_idx].add(w_flat * flat_val**2)
        mean = sums / W
        var = sq_sums / W - mean**2
        var = jnp.maximum(var, 0.0)
        sd = jnp.where(var == 0.0, 1.0, jnp.sqrt(var))
        return mean, sd

    def scale_columns(self, scale: jnp.ndarray) -> "PaddedCSR":
        """In-place-style scale-only standardization: divide every nonzero by
        its column's scale (reference src/utils.h:110-121).  Centering is NOT
        applied; the solver carries the `center/scale` correction term."""
        new_values = self.values / scale.astype(self.values.dtype)[self.indices]
        return PaddedCSR(self.indices, new_values, self.nnz, self.n_rows, self.n_cols)

    def pad_rows(self, n_total: int) -> "PaddedCSR":
        """Append all-zero rows up to n_total (batching/sharding pad)."""
        extra = n_total - self.n_rows
        if extra <= 0:
            return self
        indices = jnp.concatenate([self.indices, jnp.zeros((extra, self.row_width), jnp.int32)])
        values = jnp.concatenate([self.values, jnp.zeros((extra, self.row_width), self.values.dtype)])
        nnz = jnp.concatenate([self.nnz, jnp.zeros((extra,), jnp.int32)])
        return PaddedCSR(indices, values, nnz, n_total, self.n_cols)

    def to_dense(self) -> jnp.ndarray:
        """Densify (test/debug only)."""
        n, p = self.shape
        out = jnp.zeros((n, p), dtype=self.values.dtype)
        rows = jnp.broadcast_to(jnp.arange(n)[:, None], self.indices.shape)
        return out.at[rows, self.indices].add(self.values)

    def max_squared_row_norm(self, center_scaled: jnp.ndarray | None = None):
        """Max squared row L2 norm; with `center_scaled` given, norms of the
        centered rows ||x_i - c||^2 without densifying
        (reference src/utils.h:60-85)."""
        row_sq = jnp.sum(self.values.astype(jnp.float64) ** 2, axis=1)
        if center_scaled is None:
            return jnp.max(row_sq)
        c = center_scaled.astype(jnp.float64)
        cross = jnp.sum(self.values.astype(jnp.float64) * c[self.indices], axis=1)
        c_sq = jnp.sum(c**2)
        return jnp.max(row_sq - 2.0 * cross + c_sq)

    @partial(jax.jit, static_argnums=())
    def matvec_T(self, v: jnp.ndarray) -> jnp.ndarray:
        """x.T @ v for v of shape (n,) or (n, m): returns (p,) or (p, m)."""
        flat_idx = self.indices.reshape(-1)
        if v.ndim == 1:
            contrib = (self.values * v[:, None]).reshape(-1)
            return jnp.zeros((self.n_cols,), self.values.dtype).at[flat_idx].add(contrib)
        m = v.shape[1]
        contrib = (self.values[:, :, None] * v[:, None, :]).reshape(-1, m)
        return jnp.zeros((self.n_cols, m), self.values.dtype).at[flat_idx].add(contrib)

    def matmul_dense(self, w_t: jnp.ndarray) -> jnp.ndarray:
        """x @ w_t for dense w_t (p, k): returns (n, k) via gather."""
        gathered = w_t[self.indices]  # (n, L, k)
        return jnp.einsum("nl,nlk->nk", self.values, gathered)


@jax.tree_util.register_pytree_node_class
@dataclass
class BlockCOO:
    """Packed per-block COO view of a PaddedCSR tail (block sampling only).

    The row-padded tail layout wastes scatter/gather work: every batch step
    touches B * L elements even though only ~1/3 of them are real.  For BLOCK
    sampling the batches are fixed contiguous row blocks, so the tail's
    nonzeros can be packed per block with no row padding at all:

        rows : (n_blocks, E) int32   row index WITHIN the block [0, B)
        cols : (n_blocks, E) int32   column index
        vals : (n_blocks, E) float   values

    E = max true entries over blocks (rows are pre-shuffled by fit(), so
    per-block counts concentrate near the mean).  Pad entries are
    (row=0, col=0, val=0.0) — mathematically inert in every gather/scatter.
    Measured 1.8x faster than the padded form on the bench tail.
    """

    rows: jnp.ndarray
    cols: jnp.ndarray
    vals: jnp.ndarray
    batch: int  # B — block size these entries are packed for
    n_cols: int

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), (self.batch, self.n_cols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_padded(cls, tail: "PaddedCSR", batch: int, lane_multiple: int = 128) -> "BlockCOO":
        """Pack a (padded) tail into per-block COO (host-side numpy)."""
        indices = np.asarray(tail.indices)
        values = np.asarray(tail.values)
        nnz = np.asarray(tail.nnz)
        n, L = indices.shape
        assert n % batch == 0, "tail rows must be padded to a batch multiple"
        n_blocks = n // batch
        mask = np.arange(L)[None, :] < nnz[:, None]  # true entries
        per_block = mask.reshape(n_blocks, -1).sum(axis=1)
        E = _round_up(max(int(per_block.max()) if n_blocks else 0, 1), lane_multiple)
        rows = np.zeros((n_blocks, E), np.int32)
        cols = np.zeros((n_blocks, E), np.int32)
        vals = np.zeros((n_blocks, E), values.dtype)
        row_in_block = (np.arange(n) % batch)[:, None]
        for b in range(n_blocks):
            mb = mask[b * batch : (b + 1) * batch]
            e = int(mb.sum())
            sl = slice(b * batch, (b + 1) * batch)
            rows[b, :e] = np.broadcast_to(row_in_block[:batch], (batch, L))[mb]
            cols[b, :e] = indices[sl][mb]
            vals[b, :e] = values[sl][mb]
        return cls(
            jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), batch, tail.n_cols
        )


def scipy_column_stats(x, weights=None):
    """Host-side per-column (mean, population SD) of a scipy sparse matrix —
    zeros counted, zero-variance columns get SD 1.0: the same formula as
    PaddedCSR.column_stats (reference src/math.h:89-112), computed in numpy
    so multi-GB designs never round-trip the device.  With `weights` (n,),
    the weighted analog (sum w x / W, sum w (x - mean)^2 / W)."""
    x = canonical_csr(x)
    n, p = x.shape
    if weights is None:
        W = float(max(n, 1))
        sums = np.asarray(x.sum(axis=0)).ravel().astype(np.float64)
        sq = np.asarray(x.multiply(x).sum(axis=0)).ravel().astype(np.float64)
    else:
        w = np.asarray(weights, np.float64)
        W = max(float(w.sum()), 1e-12)
        sums = np.asarray(x.T @ w).ravel()
        sq = np.asarray(x.multiply(x).T @ w).ravel()
    mean = sums / W
    var = np.maximum(sq / W - mean**2, 0.0)
    sd = np.where(var == 0.0, 1.0, np.sqrt(var))
    return mean, sd


def scipy_row_sq_norms(x, mean=None, sd=None):
    """Host-side per-row squared norms of a scipy sparse matrix: raw
    ||x_i||^2, or ||(x_i - mean) / sd||^2 of the standardized design when
    (mean, sd) are given — expanded sparse-side as
    sum_j x_ij^2/sd_j^2 - 2 sum_j x_ij mean_j/sd_j^2 + sum_j mean_j^2/sd_j^2
    so the centered design is never materialized."""
    x = canonical_csr(x)
    xsq = x.multiply(x)
    if mean is None:
        return np.asarray(xsq.sum(axis=1)).ravel().astype(np.float64)
    inv2 = 1.0 / (np.asarray(sd, np.float64) ** 2)
    t1 = np.asarray(xsq @ inv2).ravel()
    t2 = np.asarray(x @ (np.asarray(mean, np.float64) * inv2)).ravel()
    const = float(np.sum(np.asarray(mean, np.float64) ** 2 * inv2))
    return t1 - 2.0 * t2 + const


#: rows per block of the int8 products: whole-head products (g_sum
#: refresh, lambda_max, power iteration) run block by block, so the
#: converted copy of the head never exceeds one block
INT8_ROW_BLOCK = 8192


def _int8_dot(x, y, acc):
    return jnp.dot(x.astype(acc), y.astype(acc), precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=acc)


def int8_matmul(q, b, acc=jnp.float32):
    """q @ b for an int8 q (M, D) and a float b (D, N), in `acc` at full
    precision, INT8_ROW_BLOCK rows of q at a time.

    int8 values are exact in float32, so nothing of b is rounded away.  The
    former bf16 product rounded b (the scaled coefficients) to 8
    significant bits, which put the int8 fit's fixed point ~2^-9 of |w|
    from the exact one: up to 1.06e-3*scale from the float64 reference on
    the rcv1-shaped main path, against 5.6e-5*scale in float32
    (chip_smoke.py; NVIDIA H100 80GB HBM3).  For N=1 XLA lowers either as a
    fused reduction that reads the int8 block once: 445 us per head step in
    float32 against 449 us in bf16 (int8 D=32768, B=8192; same card, 700 W,
    one process)."""
    m = q.shape[0]
    if m <= INT8_ROW_BLOCK:
        return _int8_dot(q, b, acc)
    nb, rem = divmod(m, INT8_ROW_BLOCK)
    full = q[: nb * INT8_ROW_BLOCK].reshape(nb, INT8_ROW_BLOCK, q.shape[1])
    out = jax.lax.map(lambda blk: _int8_dot(blk, b, acc), full).reshape(-1, b.shape[1])
    if rem:
        out = jnp.concatenate([out, _int8_dot(q[nb * INT8_ROW_BLOCK:], b, acc)])
    return out


def int8_tmatmul(a, q, acc=jnp.float32):
    """a.T @ q for a float a (M, N) and an int8 q (M, D), as in `int8_matmul`,
    summed over blocks of INT8_ROW_BLOCK rows; returns (N, D)."""
    m = q.shape[0]
    if m <= INT8_ROW_BLOCK:
        return _int8_dot(a.T, q, acc)
    nb, rem = divmod(m, INT8_ROW_BLOCK)
    qf = q[: nb * INT8_ROW_BLOCK].reshape(nb, INT8_ROW_BLOCK, q.shape[1])
    af = a[: nb * INT8_ROW_BLOCK].reshape(nb, INT8_ROW_BLOCK, a.shape[1])
    out, _ = jax.lax.scan(
        lambda c, xs: (c + _int8_dot(xs[0].T, xs[1], acc), None),
        jnp.zeros((a.shape[1], q.shape[1]), acc), (af, qf),
    )
    if rem:
        out = out + _int8_dot(a[nb * INT8_ROW_BLOCK:].T, q[nb * INT8_ROW_BLOCK:], acc)
    return out


#: fused nonzero count (see HybridCSR.total_nnz) — float accumulation to
#: dodge int32 wrap without x64; jit so no head-sized intermediate exists
_count_nonzero_f = jax.jit(lambda h: jnp.sum((h != 0).astype(jnp.float64)))


class HeadNNZ:
    """Host-side nonzero-only form of a quantized int8 head.

    `split_columns(head_form="nnz")` emits this instead of the dense (n, D)
    int8 block: the ~nnz quantized entries plus the per-column implicit-zero
    level `q0` (nonzero only when standardization is fused — centered zeros
    quantize to round(-mean/sd/scale)).  `materialize_int8_head` rebuilds the
    EXACT dense head on device from ~nnz bytes, so a bench-scale ingestion
    ships ~45 MB across the host->device link instead of the 3.3 GB dense
    block, and the host never materializes the dense head at all.
    """

    def __init__(self, rows, cols, vals, q0, n_rows, n_head):
        self.rows = rows  # (nnz_head,) int32
        self.cols = cols  # (nnz_head,) int32
        self.vals = vals  # (nnz_head,) int8 quantized entries
        self.q0 = q0  # (D,) int8 implicit-zero level per column
        self.n_rows = n_rows
        self.n_head = n_head

    @property
    def shape(self):
        return (self.n_rows, self.n_head)

    @property
    def dtype(self):
        return np.dtype(np.int8)

    @property
    def nbytes(self) -> int:
        return self.rows.nbytes + self.cols.nbytes + self.vals.nbytes + self.q0.nbytes


@partial(jax.jit, static_argnames=("n_rows", "n_pad"))
def _scatter_int8_head(q0, rows, cols, vals, *, n_rows, n_pad):
    # base = q0 broadcast over the real rows, 0 over padding rows (matching
    # the dense path, which pads AFTER the build with int8 zeros); the
    # scatter then writes the true entries.  One (n_pad, D) int8 buffer —
    # XLA fuses the select into the scatter init and updates in place.
    base = jnp.where(
        jnp.arange(n_pad, dtype=jnp.int32)[:, None] < n_rows, q0[None, :], jnp.int8(0)
    )
    return base.at[rows, cols].set(vals, unique_indices=True, mode="promise_in_bounds")


def materialize_int8_head(hn: HeadNNZ, n_pad: int | None = None) -> jnp.ndarray:
    """Build the dense (n_pad, D) int8 head ON DEVICE from its nonzero form.

    Bitwise-identical to uploading the dense head `split_columns` would have
    built (plus `n_pad - n_rows` zero rows when `n_pad` is given): the same
    quantized values land at the same positions over the same q0 base.  Only
    ~nnz bytes cross the host->device link instead of the dense block.
    The scatter promises unique, in-bounds indices: `split_columns` emits
    one entry per (row, col) of a canonical CSR, and `n_pad` is checked
    here.
    """
    n_pad = hn.n_rows if n_pad is None else n_pad
    if n_pad < hn.n_rows:
        raise ValueError(f"n_pad={n_pad} is smaller than the head's {hn.n_rows} rows")
    return _scatter_int8_head(
        jax.device_put(hn.q0),
        jax.device_put(hn.rows),
        jax.device_put(hn.cols),
        jax.device_put(hn.vals),
        n_rows=hn.n_rows,
        n_pad=n_pad,
    )


def _quantize_head_impl(h):
    hf = h.astype(jnp.float32)
    scale = jnp.max(jnp.abs(hf), axis=0) / 127.0
    scale = jnp.where(scale == 0.0, 1.0, scale)
    q = jnp.clip(jnp.round(hf / scale), -127, 127).astype(jnp.int8)
    return q, scale


_quantize_head = jax.jit(_quantize_head_impl)
_quantize_head_donated = jax.jit(_quantize_head_impl, donate_argnums=0)


def _std_head_impl(h, mean, sd):
    return ((h.astype(jnp.float64) - mean) / sd).astype(h.dtype)


_std_head = jax.jit(_std_head_impl)
#: same-dtype output → XLA aliases the donated input in place (peak ~1x
#: head bytes instead of the eager astype/sub/div chain's ~3x)
_std_head_donated = jax.jit(_std_head_impl, donate_argnums=0)


@jax.tree_util.register_pytree_node_class
@dataclass
class HybridCSR:
    """Dense-head / sparse-tail design matrix.

    Gathers and scatters cost far more per element than dense matmuls,
    which stream contiguous memory at close to full bandwidth — so for the
    Zipf-distributed sparsity of real text/bag-of-words data
    (rcv1-class workloads) the fastest layout stores the D most frequent
    columns as a dense (n, D) block driven entirely by matmuls, and only the
    rare-column tail as padded CSR driven by gather/scatter.  Columns are
    globally permuted so the head occupies columns [0, D); the caller keeps
    the permutation to un-permute coefficients.

    This layout is exact (no approximation): it is a column split of the
    same matrix, and the solver's updates on head and tail parts compose
    linearly.
    """

    head: jnp.ndarray  # (n, D) dense values of the D hottest columns
    tail: PaddedCSR  # (n, p) logical; entries only in columns >= D
    n_rows: int
    n_cols: int
    #: optional packed per-block COO view of the tail (block sampling; built
    #: by fit() — the solver's batch ops prefer it when the batch selector is
    #: a block start of the matching size)
    blk_tail: BlockCOO | None = None
    #: per-column dequantization scales (D,) f32 when `head` is int8
    #: (quantize_head): effective head value = head * head_scale.  Consumers
    #: fold the scales into the small operand (w, corr) so the int8 bytes are
    #: the only HBM stream.
    head_scale: jnp.ndarray | None = None

    def tree_flatten(self):
        return (self.head, self.tail, self.blk_tail, self.head_scale), (
            self.n_rows,
            self.n_cols,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        head, tail, blk_tail, head_scale = children
        return cls(head, tail, *aux, blk_tail=blk_tail, head_scale=head_scale)

    def quantize_head(self, donate: bool = False) -> "HybridCSR":
        """Symmetric per-column int8 quantization of the dense head: scale_j
        = max|head_ij| / 127, q = round(head / scale).  Halves (vs bf16) /
        quarters (vs f32) the dominant HBM stream; the solver then fits the
        elastic-net GLM of the QUANTIZED design exactly (forward and backward
        passes both use q * scale, so the fixed point is the perturbed
        problem's solution — the same argument as the bf16 head mode).
        Call AFTER standardization (quantizing then centering would break
        the int8 representation).  Per-column quantization commutes bitwise
        with row permutation and zero-row padding (neither moves a
        symmetric column max), so callers that own the buffer can quantize
        EARLY and shuffle/pad the int8 result — `donate=True` additionally
        hands the f32 head to XLA so the fused program frees it on exit
        (~1x head bytes transient instead of the eager chain's ~3x; a
        D=16384 fit crashed the 16 GB chip without this)."""
        if self.head.dtype == jnp.int8:
            return self
        fn = _quantize_head_donated if donate else _quantize_head
        q, scale = fn(self.head)
        return HybridCSR(
            q, self.tail, self.n_rows, self.n_cols,
            blk_tail=self.blk_tail, head_scale=scale,
        )

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def n_head(self) -> int:
        return self.head.shape[1]

    @classmethod
    def split_columns(
        cls,
        x_scipy,
        coverage: float = 0.75,
        max_head: int = 4096,
        dtype=jnp.float32,
        memory_budget: float | None = None,
        head_dtype=None,
        as_host: bool = False,
        std_stats=None,
        head_form: str = "dense",
    ):
        """Choose the head = smallest set of most-frequent columns covering
        `coverage` of all nonzeros (capped at max_head); returns
        (HybridCSR, perm) where perm maps new column index -> original.

        Operates directly on the raw CSR arrays (vectorized numpy) — no
        scipy fancy indexing or densify of the full matrix.

        `head_dtype` (default: `dtype`) sets the storage dtype of the dense
        head only; `jnp.bfloat16` halves the dominant device-memory stream
        at a ~0.4% relative data perturbation (solver matmuls
        still accumulate in f32) — an opt-in speed mode for workloads that
        tolerate a looser-than-1e-3 coefficient contract.  `jnp.int8`
        quantizes per column HOST-SIDE (symmetric, scales in `head_scale`)
        so only the int8 bytes cross to the device — but it quantizes the
        RAW values, so it is only correct when no standardization follows;
        `fit(hybrid_head_dtype="int8")` instead builds f32 and calls
        `quantize_head()` after standardizing.

        `as_host=True` keeps every array in numpy (the returned HybridCSR is
        a host-side container): callers that must control the host->device
        transfer convert the pieces themselves.

        `std_stats=(mean, sd)` (int8 only; ORIGINAL column order, numpy
        float64) fuses standardization into the host-side quantization: the
        head is quantized on the CENTERED+SCALED values — implicit zeros map
        to the per-column level round(-mean/sd/scale), so the emitted int8
        head IS the standardized head, element-for-element what
        `standardize()` + `quantize_head()` would produce on device — and
        the tail is emitted scale-only (divided by sd), ready for the
        solver's centering-correction term.  This is the fit() ingestion
        path for large int8 fits: only int8 bytes ever cross to the device

        `head_form="nnz"` (int8 + as_host only) returns the head as a
        `HeadNNZ` (quantized entries + per-column zero level) instead of the
        dense (n, D) block: the dense head is never built on the host, and
        `materialize_int8_head` reconstructs it bitwise-identically on
        device from ~nnz bytes — the upload drops from head bytes (GBs at
        bench scale) to ~9 bytes/nnz.
        """
        quant_int8 = head_dtype is not None and jnp.dtype(head_dtype) == jnp.int8
        if std_stats is not None and not quant_int8:
            raise ValueError("std_stats is only supported with head_dtype=int8")
        if head_form not in ("dense", "nnz"):
            raise ValueError("head_form must be 'dense' or 'nnz'")
        if head_form == "nnz" and not (quant_int8 and as_host):
            raise ValueError("head_form='nnz' requires head_dtype=int8 and as_host=True")
        if quant_int8:
            head_dtype = None
        x = canonical_csr(x_scipy)
        n, p = x.shape
        col_nnz = np.bincount(x.indices, minlength=p)
        order = np.argsort(-col_nnz, kind="stable")  # hottest first
        covered = np.cumsum(col_nnz[order])
        total = max(int(covered[-1]) if len(covered) else 0, 1)
        d = int(np.searchsorted(covered, coverage * total) + 1)
        if memory_budget is not None:  # cap head bytes: n * D * itemsize
            itemsize = jnp.dtype(
                head_dtype if head_dtype is not None else (jnp.int8 if quant_int8 else dtype)
            ).itemsize
            d = min(d, max(int(memory_budget // (n * itemsize)), 1))
        d = max(min(d, max_head, p), 1)
        d = _round_up(d, 128) if d < p else p
        d = min(d, p)
        perm = np.concatenate([order[:d], np.sort(order[d:])]).astype(np.int64)
        new_col = np.empty(p, dtype=np.int64)
        new_col[perm] = np.arange(p)

        mapped = new_col[x.indices]  # new column index per nonzero
        row_of = np.repeat(np.arange(n), np.diff(x.indptr))
        is_head = mapped < d

        if quant_int8:
            # Quantize SPARSE-side, then scatter int8 directly.  Densifying
            # first (np.zeros((n, d), f32) + `head / scale`, which promotes
            # to f64) materializes ~10-40 GB of temporaries at bench scale
            # (n=100k, D=32768) and took ~7 minutes on a 2-core host; the
            # sparse-side path touches only the ~nnz head entries plus one
            # 3.3 GB int8 allocation.  The zeros never move a symmetric
            # per-column max, so the scales are identical.
            hv = x.data[is_head].astype(np.float64)
            hc = mapped[is_head]
            hr = row_of[is_head]
            if std_stats is not None:
                # standardized head values; implicit zeros become the
                # per-column level z = -mean/sd, so the column max must
                # include |z| whenever the column has any implicit zero
                mean_o, sd_o = std_stats
                m = np.asarray(mean_o, np.float64)[perm[:d]]
                s = np.asarray(sd_o, np.float64)[perm[:d]]
                hv = (hv - m[hc]) / s[hc]
                z = -m / s
                head_col_nnz = np.bincount(hc, minlength=d)
                colmax = np.where(head_col_nnz == n, 0.0, np.abs(z))
            else:
                z = None
                colmax = np.zeros(d, np.float64)
            np.maximum.at(colmax, hc, np.abs(hv))
            scale = colmax / 127.0
            scale[scale == 0.0] = 1.0
            q0 = (
                np.clip(np.rint(z / scale), -127, 127).astype(np.int8)
                if z is not None
                else np.zeros(d, np.int8)
            )
            qv = np.clip(np.rint(hv / scale[hc]), -127, 127).astype(np.int8)
            if head_form == "nnz":
                # nonzero-only form: skip the (n, d) host materialization
                # entirely — materialize_int8_head rebuilds the identical
                # dense block on device from ~nnz bytes
                head = HeadNNZ(hr.astype(np.int32), hc.astype(np.int32), qv, q0, n, d)
            else:
                head = np.broadcast_to(q0, (n, d)).copy()
                head[hr, hc] = qv
        else:
            head = np.zeros((n, d), dtype=np.float32 if dtype == jnp.float32 else np.float64)
            head[row_of[is_head], mapped[is_head]] = x.data[is_head]

        # pack the tail entries into the padded layout directly
        t_rows = row_of[~is_head]
        t_cols = mapped[~is_head].astype(np.int32)
        t_vals = x.data[~is_head]
        if std_stats is not None:
            # scale-only tail (reference src/utils.h:110-121); the solver
            # carries the mean/sd centering correction term
            sd_new = np.asarray(std_stats[1], np.float64)[perm]
            t_vals = t_vals.astype(np.float64) / sd_new[t_cols]
        t_nnz = np.bincount(t_rows, minlength=n).astype(np.int32)
        L = _round_up(max(int(t_nnz.max()) if n else 0, 1), 8)
        # position within row: running index among this row's tail entries
        pos = np.arange(len(t_rows)) - np.repeat(
            np.concatenate([[0], np.cumsum(t_nnz)[:-1]]), t_nnz
        )
        ti = np.zeros((n, L), np.int32)
        tv = np.zeros((n, L), np.float64)
        ti[t_rows, pos] = t_cols
        tv[t_rows, pos] = t_vals
        conv = (lambda a, dt=None: a if dt is None else a.astype(np.dtype(jnp.dtype(dt)))) if as_host else (
            lambda a, dt=None: jnp.asarray(a) if dt is None else jnp.asarray(a, dtype=dt)
        )
        tail = PaddedCSR(conv(ti), conv(tv, dtype), conv(t_nnz), n, p)
        if quant_int8:
            return (
                cls(
                    conv(head), tail, n, p,
                    head_scale=conv(scale, jnp.float32),
                ),
                perm,
            )
        return cls(conv(head, head_dtype if head_dtype is not None else dtype), tail, n, p), perm

    def column_stats(self, weights=None):
        """Per-column (mean, population SD); head densely, tail sparse-aware.
        With `weights` (n,): weighted stats (see PaddedCSR.column_stats)."""
        assert self.head.dtype != jnp.int8, "column_stats before quantize_head"
        h = self.head.astype(jnp.float64)
        if weights is None:
            h_mean = jnp.mean(h, axis=0)
            h_var = jnp.mean((h - h_mean) ** 2, axis=0)
        else:
            w = weights.astype(jnp.float64).reshape(-1, 1)
            W = jnp.maximum(jnp.sum(w), 1e-12)
            h_mean = jnp.sum(h * w, axis=0) / W
            h_var = jnp.sum(w * (h - h_mean) ** 2, axis=0) / W
        h_sd = jnp.where(h_var == 0.0, 1.0, jnp.sqrt(h_var))
        t_mean, t_sd = self.tail.column_stats(weights)
        d = self.n_head
        mean = t_mean.at[:d].set(h_mean)
        sd = t_sd.at[:d].set(h_sd)
        return mean, sd

    def standardize(self, mean: jnp.ndarray, sd: jnp.ndarray, donate: bool = False):
        """Head: full center+scale (it is dense anyway).  Tail: scale-only;
        the solver carries the tail centering correction (zeros on head).
        `donate=True` (callers that own the head buffer, e.g. fit() on a
        scipy input) lets XLA alias the head in place — the standardized
        head has the same shape/dtype, so the multi-GB f32 buffer is never
        duplicated."""
        assert self.head.dtype != jnp.int8, "standardize before quantize_head"
        d = self.n_head
        fn = _std_head_donated if donate else _std_head
        head = fn(self.head, mean[:d], sd[:d])
        tail = self.tail.scale_columns(sd)
        xc = (mean / sd).at[:d].set(0.0)
        return HybridCSR(head, tail, self.n_rows, self.n_cols), xc

    def pad_rows(self, n_total: int) -> "HybridCSR":
        extra = n_total - self.n_rows
        if extra <= 0:
            return self
        head = jnp.concatenate([self.head, jnp.zeros((extra, self.n_head), self.head.dtype)])
        tail = self.tail.pad_rows(n_total)
        return HybridCSR(
            head, tail, n_total, self.n_cols,
            blk_tail=self.blk_tail, head_scale=self.head_scale,
        )

    def total_nnz(self) -> int:
        if isinstance(self.head, np.ndarray):
            head_nnz = int(np.count_nonzero(self.head))
        else:
            # count on device and read back ONE scalar, not the multi-GB
            # head.  Count in float — count_nonzero returns int32 without x64 and a
            # >=16k-wide head at bench scale has > 2^31 elements; the f32
            # tree reduction is ~1e-7-relative, fine for a stats counter.
            # MUST run jitted: the eager compare+convert chain materializes
            # a head-sized f32 intermediate (13 GB at D=32768) — jit lets
            # XLA fuse it into the reduction.
            head_nnz = int(_count_nonzero_f(self.head))
        return head_nnz + self.tail.total_nnz()

    def _head_f(self, dtype=jnp.float64) -> jnp.ndarray:
        """Dequantized head values (test/stat paths; streams full width)."""
        if self.head.dtype == jnp.int8:
            return self.head.astype(dtype) * self.head_scale.astype(dtype)
        return self.head.astype(dtype)

    def row_squared_norms(self, xc: jnp.ndarray | None = None) -> jnp.ndarray:
        """Per-row ||x_i - c||^2 (head already centered; c applies to tail)."""
        h = jnp.sum(self._head_f() ** 2, axis=1)
        vals64 = self.tail.values.astype(jnp.float64)
        t = jnp.sum(vals64**2, axis=1)
        if xc is not None:
            c = xc.astype(jnp.float64)
            cross = jnp.sum(vals64 * c[self.tail.indices], axis=1)
            t = t - 2.0 * cross + jnp.sum(c**2)
        return h + t

    def matvec_T(self, v: jnp.ndarray) -> jnp.ndarray:
        """x.T @ v: head via matmul, tail via scatter; v (n,) or (n, m).
        A bf16 head still accumulates in v's (wider) dtype; an int8 head
        streams int8 and applies the per-column scales to the (D, m) result."""
        t = self.tail.matvec_T(v)
        v2 = v if v.ndim == 2 else v[:, None]
        if self.head.dtype == jnp.int8:
            acc = jnp.promote_types(jnp.float32, v.dtype)
            h = int8_tmatmul(v2, self.head, acc=acc).T * self.head_scale[:, None].astype(acc)
        else:
            acc = jnp.promote_types(self.head.dtype, v.dtype)
            h = jnp.dot(self.head.T, v2.astype(self.head.dtype), preferred_element_type=acc)
        d = self.n_head
        if v.ndim == 1:
            return t.at[:d].add(h[:, 0].astype(t.dtype))
        return t.at[:d].add(h.astype(t.dtype))

    def matmul_dense(self, w_t: jnp.ndarray) -> jnp.ndarray:
        """x @ w_t, w_t (p, k) -> (n, k)."""
        d = self.n_head
        if self.head.dtype == jnp.int8:
            # fold the per-column scales into the small operand
            acc = jnp.promote_types(jnp.float32, w_t.dtype)
            h = int8_matmul(self.head, w_t[:d].astype(acc) * self.head_scale[:, None].astype(acc),
                            acc=acc)
            return h.astype(acc) + self.tail.matmul_dense(w_t).astype(acc)
        acc = jnp.promote_types(self.head.dtype, w_t.dtype)
        h = jnp.dot(self.head, w_t[:d].astype(self.head.dtype), preferred_element_type=acc)
        return h.astype(acc) + self.tail.matmul_dense(w_t).astype(acc)
