"""Blocked dense LDL^T factorization with inertia, for symmetric indefinite KKT systems.

This kernel fills the role HSL MA27 / MUMPS play in the reference
(/root/reference/parapint/linalg/ma27_interface.py, mumps_interface.py):
factor a symmetric indefinite matrix and report its inertia (the number of
positive/negative/zero pivots) so the interior-point loop can run its
inertia-correction scheme (/root/reference/parapint/algorithms/interior_point.py:363-400).

Design notes:

- The factorization is *unpivoted* LDL^T with 1x1 pivots.  Interior-point KKT
  matrices in the [H + Sigma_x, 0, Jeq^T, Jineq^T; ...] ordering are
  quasi-definite once regularized (positive diagonal first, negative
  constraint diagonal last), for which unpivoted LDL^T is backward stable.
  When the unregularized matrix breaks down (tiny/zero pivot), we report a
  ``singular`` status and the IP loop's existing inertia-correction retry
  adds the regularization — exactly the failure/recovery contract MA27 has
  with the reference algorithm.
- Right-looking blocked algorithm: the O(n^3) trailing update is a plain
  matmul; the O(n*b^2) panel solve is a matmul against the explicit
  inverse of the small unit-lower panel factor; only the small b x b
  diagonal block factorization is a sequential loop of rank-1 updates
  (one Triton kernel per batched panel step on the GPU, ops/pallas_ldl.py).
- Everything is shape-static and `vmap`-able: `batched_ldl_factor` factors
  [N, n, n] blocks in one XLA computation (the per-block factorizations the
  reference distributes over MPI ranks become one batched kernel here).
- f64 by default; a mixed-precision path (f32 factor + f64 iterative
  refinement) lives in :mod:`parapint_tpu.linalg.refine`.
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax


def _ldl_unblocked(A: jax.Array) -> jax.Array:
    """Unpivoted LDL^T of a small (b, b) block.

    Returns the packed factor: strict lower triangle holds L (unit diagonal
    implied), the diagonal holds D.  The strict upper triangle is garbage.
    """
    b = A.shape[-1]
    row_ids = lax.broadcasted_iota(jnp.int32, (b, 1), 0)

    def body(j, A):
        col = lax.dynamic_slice_in_dim(A, j, 1, axis=1)  # (b, 1)
        piv = lax.dynamic_slice(col, (j, 0), (1, 1))  # (1, 1)
        piv_safe = jnp.where(jnp.abs(piv) > 0, piv, 1.0)
        below = row_ids > j
        l = jnp.where(below, col / piv_safe, 0.0)
        # write [.. d_j at row j, L below ..] into column j
        newcol = jnp.where(below, l, col)
        A = lax.dynamic_update_slice_in_dim(A, newcol, j, axis=1)
        # trailing rank-1 update: A[i>j, k>j] -= l_i * (d_j l_k) and d_j*l_k == col_k
        colmask = jnp.where(row_ids > j, col, 0.0)  # (b, 1), masked to k > j
        A = A - l * colmask.T
        return A

    return lax.fori_loop(0, b, body, A, unroll=False)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _ldl_slab_batched_xla(A: jax.Array, r: int = 8) -> jax.Array:
    """Batched unpivoted LDL^T in slab form, pure XLA: (N, b, b) -> packed.

    The per-column form (`vmap(_ldl_unblocked)`) rewrites the FULL working
    matrix once per column (b dynamic-update passes over (N, b, b) — the
    dominant cost of every non-Pallas factorization: the f64 hybrid pivot
    sweep, CPU runs).  Here a `lax.fori_loop` over b/r slabs does r
    rank-1 steps on just the (N, b, r) slab, then ONE rank-r matmul
    trailing update — 16x less data per serial step and r-fold fewer
    full-matrix writes.  Same true-pivot-column dataflow as the kernels
    (the factor derives from the lower triangle only).
    """
    N, b, b2 = A.shape
    assert b == b2 and b % r == 0
    dt = A.dtype
    row_b = lax.broadcasted_iota(jnp.int32, (1, b, 1), 1)  # rows of M
    lane_r = lax.broadcasted_iota(jnp.int32, (1, 1, r), 2)  # slab col idx

    def slab_body(k, M):
        j0 = k * r
        S = lax.dynamic_slice(M, (0, 0, j0), (N, b, r))
        Xacc = jnp.zeros_like(S)  # raw masked columns (the rank-1 "x")
        for jj in range(r):
            j = j0 + jj
            col = S[:, :, jj : jj + 1]  # (N, b, 1) true column j
            piv = lax.dynamic_slice(col, (0, j, 0), (N, 1, 1))
            piv_safe = jnp.where(jnp.abs(piv) > 0, piv, jnp.ones_like(piv))
            below = row_b > j  # (1, b, 1), dynamic j
            l = jnp.where(below, col / piv_safe, jnp.zeros_like(col))
            colmask = jnp.where(below, col, jnp.zeros_like(col))
            Xacc = jnp.where(lane_r == jnp.int32(jj), colmask, Xacc)
            # x over the slab's later columns: raw column-j values at rows
            # j0+kk (kk > jj), as a (N, 1, r) row
            xs = jnp.swapaxes(
                lax.dynamic_slice(colmask, (0, j0, 0), (N, r, 1)), 1, 2
            )
            xs = jnp.where(lane_r > jnp.int32(jj), xs, jnp.zeros_like(xs))
            packed = jnp.where(below, l, col)
            S = jnp.where(lane_r == jnp.int32(jj), packed, S - l * xs)
        M = lax.dynamic_update_slice(M, S, (0, 0, j0))
        # trailing update: M[i, c] -= sum_jj L[i, jj] * X[c, jj], c >= j0+r.
        # L = S masked below the per-column diagonal; X = raw columns masked
        # to rows >= the slab end (in-slab columns were updated above).
        Lmask = row_b > (jnp.int32(j0) + lane_r)  # (1, b, r)
        Ls = jnp.where(Lmask, S, jnp.zeros_like(S))
        Xt = jnp.where(row_b >= j0 + r, Xacc, jnp.zeros_like(Xacc))
        upd = jnp.einsum(
            "nir,ncr->nic", Ls, Xt, preferred_element_type=dt
        )
        return M - upd

    return lax.fori_loop(0, b // r, slab_body, A)


def _panel_factor(Akk: jax.Array) -> jax.Array:
    """Base-case panel factorization of one (b, b) block."""
    return _panel_factor_batch(Akk[None])[0]


def unit_lower_inv(L: jax.Array) -> jax.Array:
    """Inverse of unit lower-triangular (..., n, n), any leading batch dims:
    one batched triangular solve against the identity (backward stable).

    On the H100 it matches a recursive-halving inverse built from matmuls
    at the hybrid path's (32, 1024, 1024) f32 and is at most 25 % slower at
    other n = 1024 batches, is up to 2x faster at panel widths, and
    compiles in a fraction of a second instead of ~10 s (PERF.md).  A
    Neumann-series form (I + N + N^2 + ... by repeated squaring) must not
    come back: on the chain-coupled Schur complements of the Burgers family
    its intermediate powers reached ~1e20 while ||L^{-1}|| ~ 4.5.
    """
    eye = jnp.broadcast_to(jnp.eye(L.shape[-1], dtype=L.dtype), L.shape)
    return lax.linalg.triangular_solve(
        L, eye, left_side=True, lower=True, unit_diagonal=True
    )


def ruiz_scale(A: jax.Array, iters: int = 3) -> jax.Array:
    """Symmetric Ruiz equilibration scaling s: s*A*s has rows with max
    magnitude ~1.  Interior-point KKT matrices carry barrier terms spanning
    ~16 orders of magnitude; equilibrating before a lower-precision
    factorization keeps the pivots representable (inertia is invariant
    under the congruence, by Sylvester's law).
    """
    n = A.shape[-1]
    s = jnp.ones(n, dtype=A.dtype)
    for _ in range(iters):
        As = jnp.abs(A) * s[:, None] * s[None, :]
        r = jnp.max(As, axis=1)
        r = jnp.where(r > 0, r, 1.0)
        s = s / jnp.sqrt(r)
    return s


def ldl_winv(LD: jax.Array):
    """(W, d) with W = L^{-1} from a packed LDL factor.

    K^{-1} x = W^T (W x / d): two thin matmuls per application — the
    production back-solve path.  Cheaper than materializing K^{-1} whenever
    the total number of right-hand-side columns per factorization is below
    n.
    """
    W = unit_lower_inv(jnp.tril(LD, -1) + jnp.eye(LD.shape[-1], dtype=LD.dtype))
    return W, jnp.diagonal(LD)


def winv_apply(W: jax.Array, d: jax.Array, b: jax.Array) -> jax.Array:
    """K^{-1} b given W = L^{-1} and pivots d; b is (n,) or (n, k) with
    n <= W.shape[0] (zero-padded)."""
    npad = W.shape[-1]
    n = b.shape[0]
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    if n != npad:
        b = jnp.pad(b, ((0, npad - n), (0, 0)))
    d_safe = jnp.where(jnp.abs(d) > 0, d, 1.0)
    y = jnp.matmul(W, b, preferred_element_type=b.dtype)
    x = jnp.matmul(W.T, y / d_safe[:, None], preferred_element_type=b.dtype)
    x = x[:n]
    if squeeze:
        x = x[:, 0]
    return x


def ldl_inverse(LD: jax.Array, d: jax.Array) -> jax.Array:
    """Explicit K^{-1} = L^{-T} D^{-1} L^{-1} from a packed LDL factor."""
    W = unit_lower_inv(jnp.tril(LD, -1) + jnp.eye(LD.shape[-1], dtype=LD.dtype))
    d_safe = jnp.where(jnp.abs(d) > 0, d, 1.0)
    return jnp.matmul(
        W.T, W / d_safe[:, None], preferred_element_type=LD.dtype
    )


def _ldl_recursive(A: jax.Array, bs: int) -> jax.Array:
    """Recursive packed LDL^T with static halving.

    Every level splits at a block-size multiple: all slices are static, the
    trailing update is one static-shape matmul per level, and total memory
    traffic is O(n^2 log n) — unlike a panel loop, which rewrites the whole
    loop-carried matrix once per panel (O(n^2 * n/bs) traffic).
    """
    n = A.shape[-1]
    if n <= bs:
        return _panel_factor(A)
    # split at a block-size multiple near the middle
    h = ((n // 2 + bs - 1) // bs) * bs
    if h >= n:
        h = n - bs
    A11 = A[:h, :h]
    A21 = A[h:, :h]
    A22 = A[h:, h:]
    F11 = _ldl_recursive(A11, bs)
    d1 = jnp.diagonal(F11)
    L11 = jnp.tril(F11, -1) + jnp.eye(h, dtype=A.dtype)
    W11 = unit_lower_inv(L11)
    # X = A21 L11^{-T} = L21 D1 ; L21 = X D1^{-1}
    X = jnp.matmul(A21, W11.T, preferred_element_type=A.dtype)
    d1_safe = jnp.where(jnp.abs(d1) > 0, d1, 1.0)
    L21 = X / d1_safe[None, :]
    A22u = A22 - jnp.matmul(L21, X.T, preferred_element_type=A.dtype)
    F22 = _ldl_recursive(A22u, bs)
    top = jnp.concatenate([F11, jnp.zeros((h, n - h), dtype=A.dtype)], axis=1)
    bottom = jnp.concatenate([L21, F22], axis=1)
    return jnp.concatenate([top, bottom], axis=0)


def _ldl_unrolled(A: jax.Array, bs: int) -> jax.Array:
    """Right-looking LDL^T with a statically-unrolled panel loop.

    Unlike :func:`_ldl_fori` (whose ``lax.fori_loop`` body must
    dynamic-update the FULL loop-carried matrix every panel — O(n^2 * n/bs)
    HBM traffic), unrolling the n/bs panel steps in Python makes every
    slice static, so each trailing update touches only the shrinking
    trailing submatrix: O(n^2 * 1/3 * n/bs ... ) total traffic ~3x lower,
    and XLA can overlap the independent column-panel assembly with the
    next panel's work.  n/bs is small (4-16), so HLO growth is modest.
    """
    npad = A.shape[-1]
    nb = npad // bs
    dt = A.dtype
    panels = []
    T = A
    for k in range(nb):
        Akk = T[:bs, :bs]
        Fkk = _panel_factor(Akk)
        dk = jnp.diagonal(Fkk)
        Lkk = jnp.tril(Fkk, -1) + jnp.eye(bs, dtype=dt)
        Winv = unit_lower_inv(Lkk)
        rest = T[bs:, :bs]  # (r, bs)
        X = jnp.matmul(rest, Winv.T, preferred_element_type=dt)  # L21 * D
        dk_safe = jnp.where(jnp.abs(dk) > 0, dk, 1.0)
        L21 = X / dk_safe[None, :]
        T = T[bs:, bs:] - jnp.matmul(L21, X.T, preferred_element_type=dt)
        col = jnp.concatenate(
            [jnp.zeros((k * bs, bs), dtype=dt), Fkk, L21], axis=0
        )
        panels.append(col)
    return jnp.concatenate(panels, axis=1)


def _ldl_fori(A: jax.Array, bs: int) -> jax.Array:
    """Right-looking panel-loop LDL^T (lax.fori_loop over panels).

    The default of :func:`ldl_factor`; the recursive and unrolled forms are
    the alternatives (not yet compared on the GPU).
    """
    npad = A.shape[-1]
    nb = npad // bs
    row_ids = lax.broadcasted_iota(jnp.int32, (npad, 1), 0)

    def outer(k, A):
        off = k * bs
        Akk = lax.dynamic_slice(A, (off, off), (bs, bs))
        Akk_f = _panel_factor(Akk)
        dk = jnp.diagonal(Akk_f)
        Lkk = jnp.tril(Akk_f, -1) + jnp.eye(bs, dtype=A.dtype)
        # full-height column panel; rows strictly below the diagonal block
        P = lax.dynamic_slice(A, (0, off), (npad, bs))
        below = row_ids >= off + bs  # (npad, 1)
        # X = P_below @ Lkk^{-T}  (X holds L_panel * D_k); panel solve via
        # the explicit small inverse (one matmul over the full column panel)
        X = jnp.matmul(P, unit_lower_inv(Lkk).T, preferred_element_type=A.dtype)
        X = jnp.where(below, X, 0.0)
        dk_safe = jnp.where(jnp.abs(dk) > 0, dk, 1.0)
        Lpan = X / dk_safe[None, :]
        newcols = jnp.where(below, Lpan, P)
        newcols = lax.dynamic_update_slice(newcols, Akk_f, (off, 0))
        A = lax.dynamic_update_slice(A, newcols, (0, off))
        # trailing update (matmul); operands masked below the panel
        A = A - jnp.matmul(Lpan, X.T, preferred_element_type=A.dtype)
        return A

    return lax.fori_loop(0, nb, outer, A)


@functools.partial(jax.jit, static_argnames=("block_size", "algorithm"))
def ldl_factor(A: jax.Array, block_size: int = 128, algorithm: str = "fori"):
    """Factor symmetric ``A`` (n, n) as L D L^T (unpivoted, 1x1 pivots).

    Parameters
    ----------
    A: (n, n) symmetric array.  Only the lower triangle is referenced
       logically, but the full (symmetric) matrix should be supplied.
    block_size: panel width (at most 128 keeps the panel step on the
        Triton kernel on the GPU).
    algorithm: "fori" (panel loop; default), "recursive" (static halving;
        less memory traffic on paper) or "unrolled".

    Returns
    -------
    LD: (np, np) packed factor (np = n rounded up to a multiple of
        block_size): strict lower triangle is L, diagonal is D.  Padded
        rows/cols are identity (D = 1) and are excluded from the inertia by
        :func:`ldl_inertia` via the ``n`` argument.
    d:  (np,) the diagonal D.
    """
    n = A.shape[-1]
    npad = _round_up(max(n, 1), block_size)
    if npad != n:
        # identity padding: decoupled +1 pivots
        A = jnp.pad(A, ((0, npad - n), (0, npad - n)))
        pad_ids = lax.broadcasted_iota(jnp.int32, (npad, npad), 0)
        eye_pad = jnp.logical_and(
            pad_ids >= n, pad_ids == lax.broadcasted_iota(jnp.int32, (npad, npad), 1)
        )
        A = jnp.where(eye_pad, 1.0, A)
    if algorithm == "recursive":
        LD = _ldl_recursive(A, block_size)
    elif algorithm == "unrolled":
        LD = _ldl_unrolled(A, block_size)
    else:
        LD = _ldl_fori(A, block_size)
    return LD, jnp.diagonal(LD)


@jax.jit
def ldl_solve(LD: jax.Array, b: jax.Array) -> jax.Array:
    """Solve L D L^T x = b given the packed factor from :func:`ldl_factor`.

    ``b`` may be (n,) or (n, k) with n <= LD.shape[0]; it is zero-padded to
    the factor's padded size and the result truncated back.
    """
    npad = LD.shape[-1]
    n = b.shape[0]
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    b = b.astype(LD.dtype)  # hybrid-precision path: f32 factor, f64 rhs
    if n != npad:
        b = jnp.pad(b, ((0, npad - n), (0, 0)))
    d = jnp.diagonal(LD)
    d_safe = jnp.where(jnp.abs(d) > 0, d, 1.0)
    y = lax.linalg.triangular_solve(
        LD, b, left_side=True, lower=True, unit_diagonal=True
    )
    z = y / d_safe[:, None]
    x = lax.linalg.triangular_solve(
        LD, z, left_side=True, lower=True, transpose_a=True, unit_diagonal=True
    )
    x = x[:n]
    if squeeze:
        x = x[:, 0]
    return x


@functools.partial(jax.jit, static_argnames=("n",))
def ldl_inertia(d: jax.Array, n: int | None = None, zero_tol: float = 0.0):
    """Inertia (num_pos, num_neg, num_zero) from the pivots ``d``.

    ``n``: number of *logical* pivots (excludes the kernel's internal
    padding, whose pivots are exactly +1 at indices >= n).

    A pivot is "zero" when |d_i| <= zero_tol * max(1, max_i |d_i|).  The
    default zero_tol=0.0 flags only *exact* zeros — interior-point KKT
    matrices legitimately carry pivots spanning ~15 orders of magnitude (the
    barrier terms), so any relative test misclassifies genuine tiny pivots.
    This matches MA27's behavior of reporting exact rank deficiency
    (/root/reference/parapint/linalg/ma27_interface.py:197-203 trusts
    info(15) and assumes zero zero-eigenvalues on success).
    NaN/Inf pivots count in none of the three buckets, so
    pos + neg + zero < n signals a failed (broken-down) factorization.
    """
    npad = d.shape[0]
    if n is None:
        n = npad
    ids = lax.broadcasted_iota(jnp.int32, (npad, 1), 0)[:, 0]
    valid = ids < n
    dmax = jnp.max(jnp.where(valid, jnp.abs(d), 0.0))
    tol = zero_tol * jnp.maximum(dmax, 1.0)
    is_zero = jnp.logical_and(valid, jnp.abs(d) <= tol)
    is_pos = jnp.logical_and(valid, d > tol)
    is_neg = jnp.logical_and(valid, d < -tol)
    return (
        jnp.sum(is_pos, dtype=jnp.int32),
        jnp.sum(is_neg, dtype=jnp.int32),
        jnp.sum(is_zero, dtype=jnp.int32),
    )


# ---------------------------------------------------------------------------
# Batched variants: one XLA computation factors/solves all diagonal blocks.
# This replaces the reference's per-rank loop over
# sub_solver.do_numeric_factorization
# (/root/reference/parapint/linalg/schur_complement/mpi_explicit_schur_complement.py:292-299).
# ---------------------------------------------------------------------------


def _bmm(a, b):
    return jnp.einsum("nij,njk->nik", a, b, preferred_element_type=a.dtype)


def _panel_factor_batch(Akk: jax.Array) -> jax.Array:
    """Batched base-case panel factorization (N, b, b) -> packed.

    The GPU backend runs the Triton panel kernel (ops/pallas_ldl.py) for
    the widths and dtypes of its dispatch rule; other backends and shapes run
    the XLA slab loop, or the per-column loop when b is not a multiple of 8."""
    from parapint_tpu.ops import pallas_ldl

    b = Akk.shape[-1]
    if pallas_ldl.use_kernel(b, Akk.dtype):
        return pallas_ldl.ldl_panels(Akk)
    if b % 8 == 0:
        return _ldl_slab_batched_xla(Akk)
    return jax.vmap(_ldl_unblocked)(Akk)


@functools.partial(jax.jit, static_argnames=("block_size",))
def ldl_factor_batched(A: jax.Array, block_size: int = 128):
    """Natively-batched right-looking LDL^T: (N, n, n) -> (LD, d).

    Semantically identical to ``vmap(ldl_factor)`` but written batch-first
    so each sequential panel step is ONE batched panel factorization over
    all N blocks.  All trailing updates are batched matmuls on static
    slices of the shrinking trailing submatrix.
    """
    N, n, _ = A.shape
    # snap the panel width UP to a multiple of 8: the XLA slab loop needs
    # b % 8 == 0, and odd tile sizes (e.g. the chain SC's ns=49 tiles)
    # would otherwise take the slower per-column loop; the extra rows are
    # identity padding (excluded from inertia via the n argument)
    bs = min(block_size, _round_up(max(8, n), 8))
    npad = _round_up(max(n, 1), bs)
    dt = A.dtype
    if npad != n:
        A = jnp.pad(A, ((0, 0), (0, npad - n), (0, npad - n)))
        ids = lax.broadcasted_iota(jnp.int32, (npad, npad), 0)
        eye_pad = jnp.logical_and(
            ids >= n, ids == lax.broadcasted_iota(jnp.int32, (npad, npad), 1)
        )
        A = jnp.where(eye_pad[None], 1.0, A)
    nb = npad // bs
    panels = []
    T = A
    for k in range(nb):
        Fkk, Winv = _panel_factor_batch_winv(T[:, :bs, :bs])
        dk = jnp.diagonal(Fkk, axis1=1, axis2=2)  # (N, bs)
        rest = T[:, bs:, :bs]  # (N, r, bs)
        X = jnp.einsum(
            "nij,nkj->nik", rest, Winv, preferred_element_type=dt
        )  # L21 * D
        dk_safe = jnp.where(jnp.abs(dk) > 0, dk, 1.0)
        L21 = X / dk_safe[:, None, :]
        T = T[:, bs:, bs:] - jnp.einsum(
            "nij,nkj->nik", L21, X, preferred_element_type=dt
        )
        col = jnp.concatenate(
            [jnp.zeros((N, k * bs, bs), dtype=dt), Fkk, L21], axis=1
        )
        panels.append(col)
    LD = jnp.concatenate(panels, axis=2)
    return LD, jnp.diagonal(LD, axis1=1, axis2=2)


def _panel_factor_batch_winv(Akk: jax.Array):
    """Batched base-case panel factorization + panel inverse W = L^{-1}.

    The Triton kernel accumulates W alongside the factor for panels up to
    64 wide; otherwise the unit-lower factor is inverted by one batched
    triangular solve."""
    from parapint_tpu.ops import pallas_ldl

    b = Akk.shape[-1]
    if pallas_ldl.use_kernel(b, Akk.dtype) and pallas_ldl.w_in_kernel(b):
        return pallas_ldl.ldl_panels(Akk, with_w=True)
    F = _panel_factor_batch(Akk)
    Lkk = jnp.tril(F, -1) + jnp.eye(b, dtype=Akk.dtype)
    return F, unit_lower_inv(Lkk)


def _winv_from_leaves(LD: jax.Array, leaves, lo: int, hi: int, bs: int):
    """Batched W = L^{-1} of LD[:, lo:hi, lo:hi] by recursive halving, with
    the diagonal-panel inverses supplied (``leaves[k]`` inverts panel k).
    Same recursion as :func:`unit_lower_inv`, split at panel boundaries,
    with zero base-case cost — the panels were inverted during the factor
    sweep."""
    n = hi - lo
    if n <= bs:
        return leaves[lo // bs]
    h = ((n // 2 + bs - 1) // bs) * bs
    if h >= n:
        h = n - bs
    W11 = _winv_from_leaves(LD, leaves, lo, lo + h, bs)
    W22 = _winv_from_leaves(LD, leaves, lo + h, hi, bs)
    # off-diagonal blocks of the packed factor are entirely below the
    # diagonal: they ARE L21, no masking needed
    L21 = LD[:, lo + h : hi, lo : lo + h]
    W21 = -_bmm(W22, _bmm(L21, W11))
    N = LD.shape[0]
    top = jnp.concatenate(
        [W11, jnp.zeros((N, h, n - h), dtype=LD.dtype)], axis=2
    )
    bottom = jnp.concatenate([W21, W22], axis=2)
    return jnp.concatenate([top, bottom], axis=1)


@functools.partial(jax.jit, static_argnames=("block_size",))
def ldl_factor_winv_batched(A: jax.Array, block_size: int = 128):
    """Batched LDL^T that also returns the global W = L^{-1}: (N, n, n) ->
    (LD, d, W) with all three (N, npad, npad)/(N, npad).

    Fuses the factor sweep with the inverse construction: the panel
    inverses (needed anyway for the panel solves) come out of the panel
    step, the global W is assembled from them by batched recursive
    halving, and the separate ``ldl_winv`` inversion disappears.
    """
    N, n, _ = A.shape
    # snap the panel width UP to a multiple of 8: the XLA slab loop needs
    # b % 8 == 0, and odd tile sizes (e.g. the chain SC's ns=49 tiles)
    # would otherwise take the slower per-column loop; the extra rows are
    # identity padding (excluded from inertia via the n argument)
    bs = min(block_size, _round_up(max(8, n), 8))
    npad = _round_up(max(n, 1), bs)
    dt = A.dtype
    if npad != n:
        A = jnp.pad(A, ((0, 0), (0, npad - n), (0, npad - n)))
        ids = lax.broadcasted_iota(jnp.int32, (npad, npad), 0)
        eye_pad = jnp.logical_and(
            ids >= n, ids == lax.broadcasted_iota(jnp.int32, (npad, npad), 1)
        )
        A = jnp.where(eye_pad[None], 1.0, A)
    nb = npad // bs
    panels = []
    leaves = []
    T = A
    for k in range(nb):
        Fkk, Wkk = _panel_factor_batch_winv(T[:, :bs, :bs])
        leaves.append(Wkk)
        dk = jnp.diagonal(Fkk, axis1=1, axis2=2)  # (N, bs)
        rest = T[:, bs:, :bs]  # (N, r, bs)
        X = jnp.einsum(
            "nij,nkj->nik", rest, Wkk, preferred_element_type=dt
        )  # L21 * D
        dk_safe = jnp.where(jnp.abs(dk) > 0, dk, 1.0)
        L21 = X / dk_safe[:, None, :]
        T = T[:, bs:, bs:] - jnp.einsum(
            "nij,nkj->nik", L21, X, preferred_element_type=dt
        )
        col = jnp.concatenate(
            [jnp.zeros((N, k * bs, bs), dtype=dt), Fkk, L21], axis=1
        )
        panels.append(col)
    LD = jnp.concatenate(panels, axis=2)
    W = _winv_from_leaves(LD, leaves, 0, npad, bs)
    return LD, jnp.diagonal(LD, axis1=1, axis2=2), W


batched_ldl_factor = jax.jit(
    jax.vmap(ldl_factor, in_axes=(0, None)), static_argnames=("block_size",)
)
batched_ldl_solve = jax.jit(jax.vmap(ldl_solve, in_axes=(0, 0)))
