"""Banded-matrix kernels: the structured per-block factorization path.

The reference's perf harness factors *sparse* blocks of ~600k variables with
MA27 (multifrontal) — per-block KKTs built from banded matrices
(/root/reference/parapint/examples/performance/schur_complement/create_model.py:23-47,
utils.py:24-31, defaults n_q_per_block=5000, n_y_multiplier=120 in
main.py:63-73).  A dense batched factorization cannot touch that scale
(nk^2 memory).  The answer here is not a general sparse multifrontal
code (pointer-chasing elimination trees are hostile to batched dense
hardware); it is to
exploit the *structure*: banded operators stay banded, and a symmetric
banded matrix with half-bandwidth p tiled into ts x ts tiles (ts >= p) IS a
block-tridiagonal matrix — which :mod:`parapint_tpu.linalg.tridiag` already
factors by batched cyclic reduction.

Representation: a banded matrix B (n x n) with bands d in [-p, p] is stored
row-indexed as ``bands[d + p, i] = B[i, i + d]`` (zero where the column
falls outside [0, n)).  A symmetric matrix stores only d in [0, p]
(``sym_bands[e, i] = G[i + e, i]``, the lower bands).

Everything here is O(n * p^2) elementwise work — shape-static, vmap-able
over a leading block axis, and trivially fused by XLA.
"""

import jax
import jax.numpy as jnp


def banded_matvec(bands: jax.Array, x: jax.Array) -> jax.Array:
    """B @ x for a row-indexed banded matrix.

    bands: (2p+1, n) with bands[d+p, i] = B[i, i+d];  x: (n,) or (n, k).
    """
    nb, n = bands.shape
    p = (nb - 1) // 2
    vec = x.ndim == 1
    if vec:
        x = x[:, None]
    out = jnp.zeros_like(x)
    for d in range(-p, p + 1):
        # y[i] += B[i, i+d] * x[i+d]
        xs = jnp.roll(x, -d, axis=0)
        ids = jnp.arange(n) + d
        valid = ((ids >= 0) & (ids < n))[:, None]
        out = out + jnp.where(valid, bands[d + p][:, None] * xs, 0.0)
    return out[:, 0] if vec else out


def banded_rmatvec(bands: jax.Array, y: jax.Array) -> jax.Array:
    """B.T @ y for a row-indexed banded matrix; y: (n,) or (n, k)."""
    nb, n = bands.shape
    p = (nb - 1) // 2
    vec = y.ndim == 1
    if vec:
        y = y[:, None]
    out = jnp.zeros_like(y)
    for d in range(-p, p + 1):
        # (B^T y)[j] += B[j-d... ] : (B^T y)[i+d] += B[i, i+d] * y[i]
        contrib = bands[d + p][:, None] * y
        ids = jnp.arange(n) + d
        valid = ((ids >= 0) & (ids < n))[:, None]
        out = out + jnp.roll(jnp.where(valid, contrib, 0.0), d, axis=0)
    return out[:, 0] if vec else out


def banded_btb(bands: jax.Array) -> jax.Array:
    """Lower bands of B^T B for a row-indexed banded B.

    bands: (2p+1, n) -> sym_bands (2p+1, n) with
    sym_bands[e, i] = (B^T B)[i+e, i], e in [0, 2p].

    (B^T B)[i+e, i] = sum_d B[i-d, i] B[i-d, i+e]
                    = sum_d bands[d+p, i-d] * bands[d+e+p, i-d],
    a (2p+1)^2-term elementwise stencil.
    """
    nb, n = bands.shape
    p = (nb - 1) // 2
    ids = jnp.arange(n)
    out = jnp.zeros((2 * p + 1, n), dtype=bands.dtype)
    for e in range(0, 2 * p + 1):
        acc = jnp.zeros(n, dtype=bands.dtype)
        for d in range(-p, p + 1):
            if not (-p <= d + e <= p):
                continue
            # row r = i - d must be in range; shift both factors by -d
            a = jnp.roll(bands[d + p], d)
            b = jnp.roll(bands[d + e + p], d)
            valid = ((ids - d >= 0) & (ids - d < n))
            acc = acc + jnp.where(valid, a * b, 0.0)
        # column i + e must be in range for the symmetric store
        acc = jnp.where(ids + e < n, acc, 0.0)
        out = out.at[e].set(acc)
    return out


def sym_banded_matvec(sym_bands: jax.Array, x: jax.Array) -> jax.Array:
    """G @ x for a symmetric banded matrix stored as lower bands.

    sym_bands: (p+1, n) with sym_bands[e, i] = G[i+e, i]; x: (n,) or (n, k).
    An O(n * p) stencil — the refinement matvec of the banded per-block
    factorization path (no dense (n, n) operand ever exists).
    """
    pp1, n = sym_bands.shape
    p = pp1 - 1
    vec = x.ndim == 1
    if vec:
        x = x[:, None]
    ids = jnp.arange(n)
    out = sym_bands[0][:, None] * x
    for e in range(1, p + 1):
        band = sym_bands[e][:, None]  # G[i+e, i]
        # lower part: y[i+e] += G[i+e, i] x[i]  ->  y[j] += band[j-e] x[j-e]
        valid_lo = (ids >= e)[:, None]
        out = out + jnp.where(valid_lo, jnp.roll(band * x, e, axis=0), 0.0)
        # upper part: y[i] += G[i+e, i] x[i+e]
        valid_hi = (ids + e < n)[:, None]
        out = out + jnp.where(valid_hi, band * jnp.roll(x, -e, axis=0), 0.0)
    return out[:, 0] if vec else out


def sym_band_to_tridiag_tiles(sym_bands: jax.Array, ts: int):
    """Tile a symmetric banded matrix (half-bandwidth p <= ts) into
    block-tridiagonal ts x ts tiles.

    sym_bands: (p+1, n) lower bands; n must be a multiple of ts (pad the
    matrix with identity rows first if needed — see :func:`pad_sym_band`).

    Returns (diag_tiles (m, ts, ts), upper_tiles (m-1, ts, ts)) suitable for
    :class:`parapint_tpu.linalg.tridiag.BlockTridiag`.
    """
    pp1, n = sym_bands.shape
    p = pp1 - 1
    if p > ts:
        raise ValueError(f"half-bandwidth {p} exceeds tile size {ts}")
    if n % ts != 0:
        raise ValueError(f"n={n} not a multiple of tile size {ts}")
    m = n // ts
    # Scatter-free skew construction (a per-band .at[].add loop issues
    # ~2.5(p+1) scatter-adds; pads/reshapes are pure data movement).
    #
    # Per tile g, X[b, e] = G[g*ts+b+e, g*ts+b].  Row b of the dense tile
    # column b is X[b, :] shifted DOWN by b — the standard skew trick:
    # pad rows to width W+1 (W = ts + pp1), flatten, drop the tail, and
    # re-view as (ts, W): Z[b, c] = flat[b*W + c] = X[b, c - b] (zeros
    # where c < b or c >= b + pp1).  M = Z^T then holds M[a, b] =
    # G[g*ts+a, g*ts+b] for the lower band; rows a >= ts are the coupling
    # INTO the next tile (the subdiagonal block = upper_tiles[g]^T).
    X = sym_bands.reshape(pp1, m, ts).transpose(1, 2, 0)  # (m, ts, pp1)
    W = ts + pp1
    Xp = jnp.pad(X, ((0, 0), (0, 0), (0, W + 1 - pp1)))  # (m, ts, W+1)
    Z = Xp.reshape(m, ts * (W + 1))[:, : ts * W].reshape(m, ts, W)
    Mfull = jnp.swapaxes(Z, 1, 2)  # (m, W, ts)
    Lw = Mfull[:, :ts, :]  # within-tile lower trapezoid
    diag = Lw + jnp.swapaxes(jnp.tril(Lw, -1), 1, 2)
    r = min(pp1, ts)  # cross rows a' = b + e - ts range [0, p-1] < ts
    S = Mfull[:-1, ts : ts + r, :]  # (m-1, r, ts) subdiagonal blocks
    upper = jnp.swapaxes(S, 1, 2)  # upper[g][b, a'] = S[g][a', b]
    if r < ts:
        upper = jnp.pad(upper, ((0, 0), (0, 0), (0, ts - r)))
    return diag, upper


def pad_sym_band(sym_bands: jax.Array, ts: int):
    """Pad a symmetric band store so n becomes a multiple of ts; padded
    rows are identity (+1 pivots, decoupled).  Returns (padded, n_pad)."""
    pp1, n = sym_bands.shape
    rem = (-n) % ts
    if rem == 0:
        return sym_bands, 0
    pad = jnp.zeros((pp1, rem), dtype=sym_bands.dtype)
    pad = pad.at[0].set(1.0)
    return jnp.concatenate([sym_bands, pad], axis=1), rem
