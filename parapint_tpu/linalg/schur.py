"""Explicit Schur-complement solver for block-bordered-diagonal KKT systems.

Solves the symmetric system (reference docstring,
/root/reference/parapint/linalg/schur_complement/explicit_schur_complement.py:17-27)::

    [ K_0            A_0^T ] [x_0]   [b_0]
    [      ...        ...  ] [...] = [...]
    [          K_N-1 A_N-1^T] [x_N-1] [b_N-1]
    [ A_0 ... A_N-1    Q   ] [y  ]   [b_c]

via S = Q - sum_i A_i K_i^{-1} A_i^T; factor each K_i and S; then
x_i = K_i^{-1}(b_i - A_i^T y) with y = S^{-1}(b_c - sum_i A_i K_i^{-1} b_i).

Design vs the reference:

- All diagonal blocks are factored in ONE batched LDL^T kernel
  (vs a Python loop of per-block factorizations,
  explicit_schur_complement.py:99-104).
- S is formed with one batched multi-right-hand-side triangular solve
  K_i^{-1} A_i^T followed by a batched matmul — strictly better than the
  reference's column-by-column back-solve loop over nonzero border rows
  (explicit_schur_complement.py:108-122); the multi-RHS solve and the
  A_i * V_i contraction are both dense batched matmuls.
- Blocks are uniform (padded) so the whole solver is shape-static; a
  per-block ``mask`` marks padding blocks (used when the number of logical
  blocks does not fill the batch) which contribute identity factors and are
  excluded from the inertia.

The sharded (multi-device) variant with identical math lives in
:mod:`parapint_tpu.linalg.sharded_schur`.
"""

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from parapint_tpu.linalg.base import LinearSolver
from parapint_tpu.linalg.dense import DenseLDLSolver
from parapint_tpu.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu.ops.ldl import (
    ldl_factor,
    ldl_factor_batched,
    ldl_factor_winv_batched,
    ldl_inertia,
    ldl_solve,
    ldl_winv,
    ruiz_scale,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockKKT:
    """Block-bordered-diagonal symmetric KKT system, dense uniform blocks.

    diag:   (N, nk, nk)  diagonal blocks K_i
    border: (N, nc, nk)  border blocks A_i (rows = coupling dimension)
    q:      (nc, nc)     coupling block Q
    mask:   (N,) float   1.0 for logical blocks, 0.0 for padding blocks
    """

    diag: jax.Array
    border: jax.Array
    q: jax.Array
    mask: jax.Array

    @staticmethod
    def make(diag, border, q, mask=None) -> "BlockKKT":
        if mask is None:
            mask = jnp.ones(diag.shape[0], dtype=diag.dtype)
        return BlockKKT(diag=diag, border=border, q=q, mask=mask)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LocalBlockKKT:
    """Block-bordered KKT with *block-local* borders.

    The reference stores each border A_i as a sparse matrix whose nonzero
    rows it discovers at runtime (``_BorderMatrix``,
    mpi_explicit_schur_complement.py:33-58).  Here each block instead carries
    a dense (L, nk) strip of its L local coupling rows plus a static map
    ``row_idx`` from local row to global Schur-complement row; the SC is
    assembled with one batched matmul and a scatter-add.  This keeps border
    storage O(N * L * nk) instead of O(N * nc * nk) — essential when the
    coupling dimension nc grows with N (dynamic problems: nc = (N-1)*n_states).

    diag:       (N, nk, nk)
    border_loc: (N, L, nk)   local border rows (already masked: padding rows
                             are all-zero)
    row_idx:    (N, L) int32 global SC row of each local row; masked rows
                             point at the dump index ``nc``
    q:          (nc, nc)     coupling block Q
    mask:       (N,)         1.0 for logical blocks, 0.0 for padding blocks
    """

    diag: jax.Array
    border_loc: jax.Array
    row_idx: jax.Array
    q: jax.Array
    mask: jax.Array
    # SC assembly topology (static):
    #  - "scatter": generic scatter-add through row_idx
    #  - "shared":  every block has row_idx == arange(L) (scenario structure):
    #               the SC contribution is a plain sum over blocks
    #  - "chain":   L = 2*ns with rows [bwd(ns), fwd(ns)], block i coupling
    #               to groups (i-1, i) (time-block structure): the SC is
    #               block-tridiagonal and is assembled from quadrant tiles
    #               with no scatter
    assembly: str = dataclasses.field(metadata=dict(static=True), default="scatter")

    @staticmethod
    def make(diag, border_loc, row_idx, q, mask=None, assembly="scatter") -> "LocalBlockKKT":
        if mask is None:
            mask = jnp.ones(diag.shape[0], dtype=diag.dtype)
        return LocalBlockKKT(
            diag=diag,
            border_loc=border_loc,
            row_idx=jnp.asarray(row_idx, dtype=jnp.int32),
            q=q,
            mask=mask,
            assembly=assembly,
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockRhs:
    """Right-hand side / solution for a BlockKKT system.

    blocks:   (N, nk)
    coupling: (nc,)
    """

    blocks: jax.Array
    coupling: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SchurFactor:
    block_LD: object  # (N, npad, npad) packed per-block LDL factors (or None)
    block_W: object  # (N, npad, npad) explicit L^{-1} per block (or None)
    block_d: object  # (N, npad) pivots, W-mode (or None)
    block_s: object  # (N, nk) Ruiz equilibration scaling, W-mode (or None)
    diag: object  # original diagonal blocks, kept for refinement (or None)
    q: object  # original coupling block, kept for refinement (or None)
    border: object  # (N, nc, nk) for the dense-border path, else None
    border_loc: object  # (N, L, nk) for the local-border path, else None
    row_idx: object  # (N, L) int32 for the local-border path, else None
    sc_fact: object  # factorization pytree of the SC sub-solver
    inertia: jax.Array  # (3,) int32, blocks + SC
    status: jax.Array  # () int32
    nk: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))
    # border topology ("scatter"/"shared"/"chain", see LocalBlockKKT): chain
    # dispatches the scatter-free border application in the solves/matvecs
    assembly: str = dataclasses.field(metadata=dict(static=True), default="scatter")
    # first global coupling group of this shard's blocks (sharded chain
    # path; None = 0)
    group_offset: object = None
    # full-precision W kept alongside a reduced-storage block_W when the
    # bf16 auto-gate is active (w_store_dtype + w_auto_gate): the adaptive
    # refinement retries a stalled solve with this W instead of reporting
    # an error.  None when gating is off.
    block_W_hi: object = None


def pad_block_count(kkt, multiple: int):
    """Pad a Block/LocalBlockKKT to a multiple of ``multiple`` blocks.

    Padding blocks are masked identity blocks with zero borders (local rows
    pointing at the dump index), so they factor trivially and contribute
    nothing to the Schur complement, the inertia, or the solution.  This is
    how any number of blocks >= 1 runs on any shard count, mirroring the
    reference's blocks >= ranks flexibility
    (/root/reference/parapint/interfaces/schur_complement/mpi_sc_ip_interface.py:78-79)
    without its divisibility-by-hand requirement.

    A padded CHAIN KKT falls back to ``assembly="scatter"``: the chain
    fast path places contributions by block *position* through shifted
    windows sized for exactly ng = nc/ns groups, and padding blocks beyond
    the last real group would overflow those windows — XLA clamps the
    out-of-range dynamic-slice start, silently shifting REAL blocks'
    contributions onto wrong coupling groups.  The scatter path is
    padding-safe (padded rows target the dump index), so correctness is
    preserved at the cost of the scatter-free fast path for non-divisible
    block counts only.
    """
    N = kkt.diag.shape[0]
    rem = (-N) % multiple
    if rem == 0:
        return kkt
    nk = kkt.diag.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(nk, dtype=kkt.diag.dtype), (rem, nk, nk))
    diag = jnp.concatenate([kkt.diag, eye], axis=0)
    mask = jnp.concatenate([kkt.mask, jnp.zeros(rem, dtype=kkt.mask.dtype)])
    if isinstance(kkt, LocalBlockKKT):
        L = kkt.border_loc.shape[1]
        nc = kkt.q.shape[-1]
        border_loc = jnp.concatenate(
            [kkt.border_loc, jnp.zeros((rem, L, nk), dtype=kkt.border_loc.dtype)],
            axis=0,
        )
        row_idx = jnp.concatenate(
            [kkt.row_idx, jnp.full((rem, L), nc, dtype=jnp.int32)], axis=0
        )
        return LocalBlockKKT(
            diag=diag,
            border_loc=border_loc,
            row_idx=row_idx,
            q=kkt.q,
            mask=mask,
            assembly="scatter" if kkt.assembly == "chain" else kkt.assembly,
        )
    nc = kkt.q.shape[-1]
    border = jnp.concatenate(
        [kkt.border, jnp.zeros((rem, nc, nk), dtype=kkt.border.dtype)], axis=0
    )
    return BlockKKT(diag=diag, border=border, q=kkt.q, mask=mask)


def _inertia_status(d: jax.Array, nk: int, mask: jax.Array, zero_tol: float):
    """Masked batch inertia + merged status from the per-block pivots."""
    pos, neg, zero = jax.vmap(lambda dd: ldl_inertia(dd, n=nk, zero_tol=zero_tol))(d)
    ok = (pos + neg) == nk
    # padding blocks are identity: always ok, contribute nothing
    imask = mask.astype(jnp.int32)
    inertia = jnp.stack(
        [jnp.sum(pos * imask), jnp.sum(neg * imask), jnp.sum(zero * imask)]
    )
    any_bad = jnp.any(jnp.logical_and(jnp.logical_not(ok), mask > 0))
    status = jnp.where(
        any_bad,
        jnp.int32(LinearSolverStatus.singular),
        jnp.int32(LinearSolverStatus.successful),
    )
    return inertia, status


def _factor_blocks(diag: jax.Array, mask: jax.Array, block_size: int, zero_tol: float):
    """Batched LDL^T of the diagonal blocks + per-block inertia/status."""
    nk = diag.shape[-1]
    # pass the user block size through: ldl_factor_batched snaps the panel
    # width to a multiple of 8 itself (slab-kernel eligibility) — a
    # pre-clamp to nk here would defeat that for odd tile sizes
    LD, d = ldl_factor_batched(diag, block_size=block_size)
    inertia, status = _inertia_status(d, nk, mask, zero_tol)
    return LD, inertia, status


def _factor_blocks_winv(
    diag, mask, block_size: int, zero_tol: float, factor_dtype=None,
    apply_dtype=None,
):
    """Like :func:`_factor_blocks` but returns (W, d, s) with W = L^{-1} of
    the Ruiz-equilibrated blocks (K_i^{-1} = s W^T D^{-1} W s), so every
    downstream K_i^{-1} application is two thin batched matmuls.
    Equilibration keeps a lower-precision (``factor_dtype``) factorization's
    pivot signs — and hence the inertia — intact despite the KKT's
    barrier-term dynamic range.

    ``apply_dtype`` enables the HYBRID-precision path: the LDL^T pivot
    sweep runs in ``factor_dtype`` (f64 for blocks whose elimination is
    cancellation-heavy — e.g. single-time-step chain blocks, where an f32
    sweep cannot even determine pivot signs), the pivots/inertia are read
    from that accurate factor, and then the factor is *cast down* so the
    O(n^3) L^{-1} construction and every downstream multi-RHS apply (the
    bulk of the flops: Schur-complement formation, back solves) run at
    ``apply_dtype`` (f32) speed.  The cast-induced O(eps_f32) solve error
    is removed by the solver's f64 iterative refinement; the inertia — the
    part refinement cannot fix — keeps full factor-dtype fidelity.
    """
    nk = diag.shape[-1]
    # cast FIRST, then equilibrate in factor_dtype: the Ruiz sweeps are 3-4
    # full passes over the (N, nk, nk) batch, by far the largest memory
    # traffic of this function when the input is f64 — the scale factors
    # themselves only need ~1e-3 relative accuracy, so computing them on the
    # already-cast matrix is equivalent
    if factor_dtype is not None:
        diag = diag.astype(factor_dtype)
    s = jax.vmap(ruiz_scale)(diag)  # (N, nk)
    diag = diag * s[:, :, None] * s[:, None, :]
    if apply_dtype is None or apply_dtype == diag.dtype:
        # fused factor + W sweep: panel inverses come out of the factor
        # kernel, the global W is assembled by recursive halving from them
        LD, d, W = ldl_factor_winv_batched(diag, block_size=block_size)
        inertia, status = _inertia_status(d, nk, mask, zero_tol)
        return W, d, s, inertia, status
    LD, inertia, status = _factor_blocks(diag, mask, block_size, zero_tol)
    if LD.dtype != apply_dtype:
        LD = LD.astype(apply_dtype)
        s = s.astype(apply_dtype)
    W, d = jax.vmap(ldl_winv)(LD)
    return W, d, s, inertia, status


def _winv_apply_batched(W, d, s, b):
    """K_i^{-1} b_i for a batch: b (N, nk) -> (N, nk).

    Two batched GEMVs against W.  A bf16-stored W is upcast to f32 at
    compute (the convert fuses into the dot; the reads stay bf16-sized).
    """
    cdt = jnp.float32 if W.dtype == jnp.bfloat16 else W.dtype
    Wc = W.astype(cdt)
    nk = b.shape[-1]
    npad = W.shape[-1]
    sf = s.astype(cdt)
    bf = b.astype(cdt) * sf
    if npad != nk:
        bf = jnp.pad(bf, ((0, 0), (0, npad - nk)))
    d_safe = jnp.where(jnp.abs(d) > 0, d, 1.0).astype(cdt)
    y = jnp.einsum("bij,bj->bi", Wc, bf, preferred_element_type=cdt)
    x = jnp.einsum("bji,bj->bi", Wc, y / d_safe, preferred_element_type=cdt)
    return x[:, :nk] * sf


def _sc_contribution(LD: jax.Array, border: jax.Array, mask: jax.Array):
    """sum_i A_i K_i^{-1} A_i^T over the (local) batch of blocks."""
    # V_i = K_i^{-1} A_i^T : batched multi-RHS solve, (N, nk, nc)
    V = jax.vmap(lambda ld, a: ldl_solve(ld, a.T))(LD, border)
    # contribution_i = A_i @ V_i ; masked sum over blocks (one contraction)
    return jnp.einsum(
        "bci,bik,b->ck", border, V, mask, preferred_element_type=border.dtype
    )


def _form_sc(LD: jax.Array, border: jax.Array, q: jax.Array, mask: jax.Array):
    """S = Q - sum_i A_i K_i^{-1} A_i^T, all blocks batched."""
    return q - _sc_contribution(LD, border, mask)


# -- local-border helpers ----------------------------------------------------


def _winv_multi(W, d, s, A_cols):
    """U = W @ (s * A_cols) and S = U^T D^{-1} U per block (A K^{-1} A^T in
    scaled symmetric W-form); A_cols is (N, nk, L).  Returns S (N, L, L)."""
    nk = A_cols.shape[1]
    npad = W.shape[-1]
    Af = A_cols.astype(W.dtype) * s[:, :, None]
    if npad != nk:
        Af = jnp.pad(Af, ((0, 0), (0, npad - nk), (0, 0)))
    U = jnp.einsum("bij,bjl->bil", W, Af, preferred_element_type=W.dtype)
    d_safe = jnp.where(jnp.abs(d) > 0, d, 1.0)
    return jnp.einsum(
        "bpl,bpk->blk", U, U / d_safe[:, :, None], preferred_element_type=W.dtype
    )


def _sc_contribution_winv(W, d, s, border, mask):
    """W-mode dense-border SC contribution: all matmuls."""
    S = _winv_multi(W, d, s, jnp.swapaxes(border, 1, 2))  # (N, nc, nc)
    return jnp.einsum("bck,b->ck", S, mask.astype(S.dtype))


def _scatter_sc(S_loc, row_idx, nc: int):
    out = jnp.zeros((nc + 1, nc + 1), dtype=S_loc.dtype)
    out = out.at[row_idx[:, :, None], row_idx[:, None, :]].add(S_loc)
    return out[:nc, :nc]


def _chain_tiles(S_loc, nc: int, group_offset=None):
    """Chain-topology SC contribution in block-tridiagonal *tile* form.

    Returns ``(diag_tiles (ng, ns, ns), upper_full (ng, ns, ns))`` where
    ``upper_full[g]`` is the (c_g, c_{g+1}) tile (index ng-1 is structurally
    unused — the last coupling group has no successor — and is dropped by
    consumers).  Keeping the SC in tile form is what the block-tridiagonal
    (cyclic-reduction) coupling solver consumes: O(nc*ns) data instead of
    the dense O(nc^2), which also shrinks the cross-shard psum by the same
    factor.
    """
    Nb, L, _ = S_loc.shape
    ns = L // 2
    ng = nc // ns  # number of coupling groups (global blocks - 1)
    dt = S_loc.dtype
    # quadrants: rows/cols [bwd -> c_{i-1} | fwd -> c_i]
    bb = S_loc[:, :ns, :ns]
    bf = S_loc[:, :ns, ns:]
    ff = S_loc[:, ns:, ns:]
    off = group_offset if group_offset is not None else 0

    def place(tiles, start):
        # tiles for global tile-rows [start, start+Nb); out-of-range
        # writes land in the sacrificial border rows (their tiles are
        # zero by the link masks)
        out = jnp.zeros((ng + 2, ns, ns), dtype=dt)
        idx = jnp.asarray(start + 1, dtype=jnp.int32)
        zero = jnp.int32(0)
        out = lax.dynamic_update_slice(out, tiles, (idx, zero, zero))
        return out[1 : ng + 1]

    # S tile-diag[g] = ff[block g] + bb[block g+1];
    # S tile-upper[g] (c_g, c_{g+1}) = bf[block g+1]; lower = upper^T
    diag_tiles = place(ff, off) + place(bb, off - 1)
    upper_full = place(bf, off - 1)
    return diag_tiles, upper_full


def _assemble_sc(S_loc, row_idx, nc: int, assembly: str, group_offset=None):
    """Place per-block local SC contributions (N, L, L) into the global
    (nc, nc) Schur complement.

    "scatter" works for any topology; "shared" and "chain" are scatter-free
    specializations (pure data movement instead of scatters) for the two structures the
    interfaces produce — see LocalBlockKKT.assembly.
    """
    if assembly == "shared":
        # every block's rows target coupling rows 0..L-1 directly
        return jnp.sum(S_loc, axis=0)
    if assembly == "chain":
        Nb, L, _ = S_loc.shape
        ns = L // 2
        if ns == 0 or nc % max(ns, 1) != 0:
            return _scatter_sc(S_loc, row_idx, nc)
        ng = nc // ns
        dt = S_loc.dtype
        diag_tiles, upper_tiles = _chain_tiles(S_loc, nc, group_offset)
        eye = jnp.eye(ng, dtype=dt)
        up = jnp.eye(ng, k=1, dtype=dt)
        Sd = jnp.einsum("gij,gh->gihj", diag_tiles, eye)
        Su = jnp.einsum("gij,gh->gihj", upper_tiles, up)
        S = (Sd + Su).reshape(nc, nc)
        return S + Su.reshape(nc, nc).T
    return _scatter_sc(S_loc, row_idx, nc)


def _sc_contribution_local(
    LD, border_loc, row_idx, nc: int, assembly: str = "scatter", group_offset=None
):
    """sum_i P_i (A_i K_i^{-1} A_i^T) P_i^T via batched solve + assembly.

    Local rows map to global SC rows through ``row_idx`` (masked rows point
    at the dump index nc) or through the structured assembly modes.
    """
    V = jax.vmap(lambda ld, a: ldl_solve(ld, a.T))(LD, border_loc)  # (N, nk, L)
    S_loc = jnp.einsum(
        "bli,bik->blk", border_loc, V, preferred_element_type=border_loc.dtype
    )  # (N, L, L)
    return _assemble_sc(S_loc, row_idx, nc, assembly, group_offset)


def _sc_contribution_local_winv(
    W, d, s, border_loc, row_idx, nc: int, assembly: str = "scatter", group_offset=None
):
    """W-mode local-border SC contribution: all matmuls + assembly."""
    S_loc = _winv_multi(W, d, s, jnp.swapaxes(border_loc, 1, 2))  # (N, L, L)
    return _assemble_sc(S_loc, row_idx, nc, assembly, group_offset)


def _sc_tiles_local_winv(W, d, s, border_loc, nc: int, group_offset=None):
    """Chain-topology SC contribution in tile form (W-mode)."""
    S_loc = _winv_multi(W, d, s, jnp.swapaxes(border_loc, 1, 2))
    return _chain_tiles(S_loc, nc, group_offset)


def _sc_tiles_local(LD, border_loc, nc: int, group_offset=None):
    """Chain-topology SC contribution in tile form (packed-LDL mode)."""
    V = jax.vmap(lambda ld, a: ldl_solve(ld, a.T))(LD, border_loc)
    S_loc = jnp.einsum(
        "bli,bik->blk", border_loc, V, preferred_element_type=border_loc.dtype
    )
    return _chain_tiles(S_loc, nc, group_offset)


def _tridiag_sc_capable(sc_solver, kkt) -> bool:
    """True when the coupling solve can stay in block-tridiagonal tile form:
    chain topology + a tile-form-capable SC solver."""
    from parapint_tpu.linalg.tridiag import BlockTridiagSolver

    if not isinstance(sc_solver, BlockTridiagSolver):
        return False
    if not isinstance(kkt, LocalBlockKKT) or kkt.assembly != "chain":
        return False
    ns = kkt.border_loc.shape[1] // 2
    nc = kkt.q.shape[-1]
    return ns > 0 and nc > 0 and nc % ns == 0


def _border_apply_local(border_loc, row_idx, v, nc: int):
    """sum_i P_i A_i v_i -> (nc,)"""
    contrib = jnp.einsum(
        "bli,bi->bl", border_loc, v, preferred_element_type=v.dtype
    )
    out = jnp.zeros(nc + 1, dtype=v.dtype)
    out = out.at[row_idx].add(contrib)
    return out[:nc]


def _border_T_apply_local(border_loc, row_idx, y):
    """A_i^T P_i^T y per block -> (N, nk)"""
    y_pad = jnp.concatenate([y, jnp.zeros(1, dtype=y.dtype)])
    y_loc = y_pad[row_idx]  # (N, L)
    # batched GEMM, not einsum "bli,bl->bi" — see _border_T_apply_chain
    return jnp.matmul(
        y_loc[:, None, :], border_loc, preferred_element_type=y.dtype
    )[:, 0, :]


def _chain_border_ok(assembly, border_loc, nc: int) -> bool:
    """True when the scatter-free chain border application applies."""
    if assembly != "chain" or border_loc is None:
        return False
    L = border_loc.shape[1]
    ns = L // 2
    return L % 2 == 0 and ns > 0 and nc > 0 and nc % ns == 0


def _border_apply_chain(border_loc, v, nc: int, group_offset=None):
    """Chain-topology sum_i P_i A_i v_i -> (nc,) with NO scatter.

    Rows [0, ns) of block b target coupling group b-1, rows [ns, 2ns)
    target group b (the dynamic-interface link layout); the scatter-add of
    :func:`_border_apply_local` is replaced by two shifted contiguous
    placements, pure data movement.
    Out-of-range rows (block 0 backward / last block forward, and the
    sharded case's halo) land in sacrificial border rows; their border_loc
    rows are all-zero by the link masks, so they contribute nothing.
    """
    L = border_loc.shape[1]
    ns = L // 2
    ng = nc // ns
    # batched GEMM form (not einsum "bli,bi->bl"): the explicit
    # (b,L,nk)@(b,nk,1) matmul is one plain batched contraction
    contrib = jnp.matmul(
        border_loc, v[:, :, None], preferred_element_type=v.dtype
    )[..., 0]
    bwd = contrib[:, :ns]
    fwd = contrib[:, ns:]
    off = group_offset if group_offset is not None else 0

    def place(rows, start):
        out = jnp.zeros((ng + 2, ns), dtype=v.dtype)
        idx = jnp.asarray(start + 1, dtype=jnp.int32)
        out = lax.dynamic_update_slice(out, rows, (idx, jnp.int32(0)))
        return out[1 : ng + 1]

    return (place(fwd, off) + place(bwd, off - 1)).reshape(nc)


def _border_y_loc_chain(y, Nb: int, L: int, group_offset=None):
    """(Nb, L) per-block local rows of the coupling vector for the chain
    topology: rows [0, ns) read group b-1, rows [ns, 2ns) read group b."""
    ns = L // 2
    yg = y.reshape(-1, ns)
    off = group_offset if group_offset is not None else 0
    z = jnp.zeros((1, ns), dtype=y.dtype)
    ext = jnp.concatenate([z, yg, z], axis=0)  # ext[g + 1] = group g
    offi = jnp.asarray(off, dtype=jnp.int32)
    bwd_y = lax.dynamic_slice(ext, (offi, jnp.int32(0)), (Nb, ns))
    fwd_y = lax.dynamic_slice(ext, (offi + 1, jnp.int32(0)), (Nb, ns))
    return jnp.concatenate([bwd_y, fwd_y], axis=1)  # (Nb, L)


def _border_T_apply_chain(border_loc, y, group_offset=None):
    """Chain-topology A_i^T P_i^T y per block -> (N, nk) with NO gather:
    each block reads two contiguous coupling groups (see
    :func:`_border_apply_chain`)."""
    Nb, L, _ = border_loc.shape
    y_loc = _border_y_loc_chain(y, Nb, L, group_offset)
    # (b,1,L)@(b,L,nk) batched GEMM — see _border_apply_chain on why not
    # einsum "bli,bl->bi"
    return jnp.matmul(
        y_loc[:, None, :], border_loc, preferred_element_type=y.dtype
    )[:, 0, :]


def _kkt_matvec(
    fact: "SchurFactor", x: "BlockRhs", psum_axis=None, dtype=None
) -> "BlockRhs":
    """K @ x for the full block-bordered system (used by iterative
    refinement).  With ``psum_axis`` set, the coupling part is reduced over
    the mesh axis (shard_map context).  With ``dtype`` set, all operands are
    cast first — the cheap low-precision residual probe of the adaptive
    refinement (an f32 matvec moves half the bytes of the f64 one)."""
    diag, q = fact.diag, fact.q
    xb, xc = x.blocks, x.coupling
    border = fact.border
    border_loc = fact.border_loc
    if dtype is not None:
        diag = diag.astype(dtype)
        q = q.astype(dtype)
        xb = xb.astype(dtype)
        xc = xc.astype(dtype)
        border = None if border is None else border.astype(dtype)
        border_loc = None if border_loc is None else border_loc.astype(dtype)
    bx = jnp.einsum("bij,bj->bi", diag, xb, preferred_element_type=xb.dtype)
    if _chain_border_ok(fact.assembly, border_loc, fact.nc):
        bx = bx + _border_T_apply_chain(border_loc, xc, fact.group_offset)
        cy = _border_apply_chain(border_loc, xb, fact.nc, fact.group_offset)
    elif border_loc is not None:
        bx = bx + _border_T_apply_local(border_loc, fact.row_idx, xc)
        cy = _border_apply_local(border_loc, fact.row_idx, xb, fact.nc)
    else:
        bx = bx + jnp.einsum(
            "bci,c->bi", border, xc, preferred_element_type=xb.dtype
        )
        cy = jnp.einsum(
            "bci,bi->c", border, xb, preferred_element_type=xb.dtype
        )
    if psum_axis is not None:
        cy = jax.lax.psum(cy, psum_axis)
    cy = cy + jnp.matmul(q, xc, preferred_element_type=cy.dtype)
    return BlockRhs(blocks=bx, coupling=cy)


def _refine_probe(
    fact: "SchurFactor",
    rhs: "BlockRhs",
    x: "BlockRhs",
    trigger: float,
    psum_axis=None,
):
    """f32 residual check: True when ||rhs - K x|| exceeds BOTH
    trigger * max(1, ||rhs||) and the probe's own measurement floor.

    Runs entirely in f32 (cheap) — it only needs to detect gross
    solve failure, so a residual the f32 matvec cannot even resolve must
    not count as one.  The f32 matvec's error is ~eps_f32 * (|K| |x|): on
    ill-scaled KKTs (barrier terms spanning ~1e10) with O(1) rhs,
    ||K|| ||x|| >> ||rhs|| and the raw rhs-relative test can NEVER pass —
    a converged solve (true f64 residual ~1e-11) would burn every
    refinement pass and then report a bogus error.  The floor is the
    2-norm of the absolute-value matvec scaled by 32 * eps_f32.  With
    ``psum_axis``, block norms reduce over the mesh axis (the coupling
    part is replicated and is added once).
    """
    f32 = jnp.float32
    kx = _kkt_matvec(fact, x, psum_axis=psum_axis, dtype=f32)
    # |K| |x| through the same matvec structure (all operands nonnegative)
    afact = dataclasses.replace(
        fact,
        diag=jnp.abs(fact.diag),
        q=jnp.abs(fact.q),
        border=None if fact.border is None else jnp.abs(fact.border),
        border_loc=(
            None if fact.border_loc is None else jnp.abs(fact.border_loc)
        ),
    )
    ax = BlockRhs(blocks=jnp.abs(x.blocks), coupling=jnp.abs(x.coupling))
    kabs = _kkt_matvec(afact, ax, psum_axis=psum_axis, dtype=f32)
    # the MATVECS run in f32 (the expensive part); the norm reductions run
    # in the rhs working dtype (f64) — squares of large f32 values (garbage
    # iterates reach ~1e20, kabs ~1e20 -> squares ~1e40) overflow f32 to
    # inf, and `rn2 > inf` would silently read as converged
    wd = rhs.blocks.dtype
    rb = rhs.blocks.astype(f32).astype(wd) - kx.blocks.astype(wd)
    rc = rhs.coupling.astype(f32).astype(wd) - kx.coupling.astype(wd)
    rb2 = jnp.sum(rb * rb)
    bb2 = jnp.sum(rhs.blocks.astype(wd) ** 2)
    fb2 = jnp.sum(kabs.blocks.astype(wd) ** 2)
    if psum_axis is not None:
        rb2 = jax.lax.psum(rb2, psum_axis)
        bb2 = jax.lax.psum(bb2, psum_axis)
        fb2 = jax.lax.psum(fb2, psum_axis)
    rn2 = rb2 + jnp.sum(rc * rc)
    bn2 = bb2 + jnp.sum(rhs.coupling.astype(wd) ** 2)
    fn2 = fb2 + jnp.sum(kabs.coupling.astype(wd) ** 2)
    eps = 32.0 * np.finfo(np.float32).eps
    floor2 = (eps * eps) * fn2
    # a non-finite residual (diverged refinement, NaN-poisoned solve) MUST
    # count as failure: NaN > thresh is False and would read as converged
    bad = jnp.logical_not(jnp.isfinite(rn2))
    return jnp.logical_or(
        bad,
        rn2 > jnp.maximum((trigger * trigger) * jnp.maximum(1.0, bn2), floor2),
    )


class SchurComplementSolver(LinearSolver):
    """Serial (single-device) Schur-complement solver.

    Composes the batched per-block LDL^T with any :class:`LinearSolver` for
    the Schur complement (the reference's dependency-injection seam,
    explicit_schur_complement.py:28-39).
    """

    def __init__(
        self,
        schur_complement_solver: Optional[LinearSolver] = None,
        block_size: int = 128,
        zero_tol: float = 0.0,
        explicit_inverse: bool = False,
        refine_steps: Optional[int] = None,
        factor_dtype=None,
        apply_dtype=None,
        refine_trigger: float = 1e-5,
        refine_max_passes: int = 8,
        w_store_dtype=None,
        w_auto_gate: bool = True,
    ):
        self.sc_solver = (
            schur_complement_solver
            if schur_complement_solver is not None
            else DenseLDLSolver(
                block_size=block_size,
                zero_tol=zero_tol,
                explicit_inverse=explicit_inverse,
                # the SC is formed in factor_dtype already; its own internal
                # refinement is unnecessary (global refinement covers it)
                refine_steps=0,
            )
        )
        self.block_size = block_size
        self.zero_tol = zero_tol
        self.explicit_inverse = explicit_inverse
        self.factor_dtype = factor_dtype
        # w_store_dtype (e.g. jnp.bfloat16): dtype W is STORED in for the
        # back-solve applies — the SC is still formed from the full
        # factor-dtype W, and pivots/scales stay in factor dtype.  Halves
        # the HBM-bound W reads of every solve; the O(2^-8) apply rounding
        # is absorbed by iterative refinement (do not combine with
        # refine_steps=0 unless validated for the problem).  OPT-IN and
        # problem-dependent: on kappa(K)-hard blocks the bf16 apply error
        # can exceed the refinement contraction threshold and the solve
        # reports status=error (observed on the dynamics example family;
        # the Burgers benchmark family converges with objective parity at
        # +1 IP iteration).
        self.w_store_dtype = w_store_dtype
        # w_auto_gate (with w_store_dtype set + adaptive
        # refinement): keep the pre-cast W alongside; when the adaptive
        # refinement STALLS on the reduced-precision applies (the
        # kappa-hard case that previously reported status=error,
        # linalg/results.py:4-15-style graceful failure), redo the solve +
        # refinement with the full-precision W instead.  Memory cost: +50%
        # of W (f32 + bf16); no per-solve cost on the fast path beyond the
        # probe the adaptive mode already runs.
        self.w_auto_gate = w_auto_gate
        # hybrid precision: factor pivots in factor_dtype (e.g. f64 when the
        # blocks' elimination is cancellation-heavy), every apply in
        # apply_dtype (f32); see _factor_blocks_winv
        self.apply_dtype = apply_dtype
        # refine_steps=None -> ADAPTIVE refinement (the default): after each
        # solve a cheap f32 residual probe decides whether the expensive
        # f64-emulated refinement passes run at all, iterating (up to
        # refine_max_passes) until the probe passes.  Well-conditioned
        # problems (e.g. the Burgers benchmark) then run at refine_steps=0
        # speed (the f64 residual matvec is the single largest
        # per-iteration cost), while problems whose factorization carries
        # noise-floor pivots (see _factor_blocks) or whose f32 solve stalls
        # keep refining to full step accuracy — and report a solve error if
        # the cap is hit.  Pass an explicit integer to force a fixed number
        # of passes.
        self.adaptive_refine = refine_steps is None
        if refine_steps is None:
            refine_steps = 1
        self.refine_steps = refine_steps
        self.refine_trigger = refine_trigger
        self.refine_max_passes = refine_max_passes

    def symbolic(self, kkt) -> LinearSolverResults:
        N, nk, nk2 = kkt.diag.shape
        if nk != nk2:
            raise ValueError(f"diagonal blocks are not square: {kkt.diag.shape}")
        nc = kkt.q.shape[-1]
        if isinstance(kkt, LocalBlockKKT):
            if kkt.border_loc.shape[0] != N or kkt.border_loc.shape[2] != nk:
                raise ValueError(
                    f"border_loc shape {kkt.border_loc.shape} inconsistent "
                    f"with diag {kkt.diag.shape}"
                )
            if kkt.row_idx.shape != kkt.border_loc.shape[:2]:
                raise ValueError("row_idx must be (N, L)")
        else:
            if kkt.border.shape != (N, nc, nk):
                raise ValueError(
                    f"border shape {kkt.border.shape} inconsistent with "
                    f"diag {kkt.diag.shape} and q {kkt.q.shape}"
                )
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def _use_tridiag_sc(self, kkt) -> bool:
        return _tridiag_sc_capable(self.sc_solver, kkt)

    def numeric(self, kkt) -> SchurFactor:
        from parapint_tpu.linalg.tridiag import BlockTridiag, extract_tridiag

        nk = kkt.diag.shape[-1]
        nc = kkt.q.shape[-1]
        local = isinstance(kkt, LocalBlockKKT)
        tridiag = self._use_tridiag_sc(kkt)
        ns = kkt.border_loc.shape[1] // 2 if local else 0
        # phase labels mirror the reference solver's internal timers
        # ("factorize diagonal blocks" / "form SC" / "factorize SC",
        # mpi_explicit_schur_complement.py:207-360) so jax.profiler traces
        # attribute per-phase device time the same way MPI rank timings do
        if self.explicit_inverse:
            with jax.named_scope("sc_solver.factor_blocks"):
                W, d, s, blk_inertia, blk_status = _factor_blocks_winv(
                    kkt.diag, kkt.mask, self.block_size, self.zero_tol,
                    self.factor_dtype, apply_dtype=self.apply_dtype,
                )
            LD = None
            with jax.named_scope("sc_solver.form_sc"):
                if tridiag:
                    dt_c, ut_full = _sc_tiles_local_winv(
                        W, d, s, kkt.border_loc, nc
                    )
                    q_tri = extract_tridiag(kkt.q.astype(W.dtype), ns)
                    sc = BlockTridiag(
                        diag=q_tri.diag - dt_c, upper=q_tri.upper - ut_full[:-1]
                    )
                elif local:
                    contrib = _sc_contribution_local_winv(
                        W, d, s, kkt.border_loc, kkt.row_idx, nc, kkt.assembly
                    )
                    sc = kkt.q.astype(W.dtype) - contrib
                else:
                    contrib = _sc_contribution_winv(W, d, s, kkt.border, kkt.mask)
                    sc = kkt.q.astype(W.dtype) - contrib
            W_hi = None
            if self.w_store_dtype is not None:
                if self.w_auto_gate and self.adaptive_refine:
                    W_hi = W
                W = W.astype(self.w_store_dtype)
        else:
            W = d = s = W_hi = None
            border_f = kkt.border_loc if local else kkt.border
            with jax.named_scope("sc_solver.factor_blocks"):
                LD, blk_inertia, blk_status = _factor_blocks(
                    kkt.diag, kkt.mask, self.block_size, self.zero_tol
                )
            if self.apply_dtype is not None and LD.dtype != self.apply_dtype:
                # hybrid precision, LD form: pivots/inertia from the
                # factor-dtype (f64) sweep, then the factor is cast down so
                # the multi-RHS triangular solves (SC formation + back
                # solves) run in apply_dtype.  The cast is a pure per-entry
                # relative rounding — no cancellation — so the factor stays
                # a contraction-quality preconditioner even when the sweep
                # itself would be meaningless in f32; deliberately NO
                # equilibration here (rescaling turns the huge-but-relative
                # entries of tiny-pivot eliminations into O(1)-absolute
                # rounding errors), and no explicit inverse (the W form's
                # Neumann products overflow f32 on 1e12-scale L entries).
                LD = LD.astype(self.apply_dtype)
            with jax.named_scope("sc_solver.form_sc"):
                if tridiag:
                    dt_c, ut_full = _sc_tiles_local(LD, border_f, nc)
                    q_tri = extract_tridiag(kkt.q, ns)
                    sc = BlockTridiag(
                        diag=q_tri.diag - dt_c, upper=q_tri.upper - ut_full[:-1]
                    )
                elif local:
                    sc = kkt.q - _sc_contribution_local(
                        LD, border_f, kkt.row_idx, nc, kkt.assembly
                    )
                else:
                    sc = _form_sc(LD, border_f, kkt.q, kkt.mask)
        with jax.named_scope("sc_solver.factor_sc"):
            sc_fact = self.sc_solver.numeric(sc)
        sc_pos, sc_neg, sc_zero = self.sc_solver.inertia(sc_fact)
        inertia = blk_inertia + jnp.stack([sc_pos, sc_neg, sc_zero])
        status = jnp.maximum(blk_status, self.sc_solver.status(sc_fact))
        keep = self.refine_steps > 0
        return SchurFactor(
            block_LD=LD,
            block_W=W,
            block_W_hi=W_hi,
            block_d=d,
            block_s=s,
            diag=kkt.diag if keep else None,
            q=kkt.q if keep else None,
            border=None if local else kkt.border,
            border_loc=kkt.border_loc if local else None,
            row_idx=kkt.row_idx if local else None,
            sc_fact=sc_fact,
            inertia=inertia,
            status=status,
            nk=nk,
            nc=nc,
            assembly=kkt.assembly if local else "scatter",
        )

    def _apply_blocks(self, fact: SchurFactor, b, hi: bool = False):
        """K_i^{-1} b_i for every block (in the factor's dtype).

        ``hi``: use the full-precision W (bf16 auto-gate fallback path)."""
        W = fact.block_W_hi if (hi and fact.block_W_hi is not None) else fact.block_W
        if W is not None:
            return _winv_apply_batched(W, fact.block_d, fact.block_s, b)
        b = b.astype(fact.block_LD.dtype)
        return jax.vmap(lambda ld, bb: ldl_solve(ld, bb))(fact.block_LD, b)[
            :, : fact.nk
        ]

    def _solve_once(self, fact: SchurFactor, rhs: BlockRhs, hi: bool = False) -> BlockRhs:
        local = fact.border is None
        chain = _chain_border_ok(fact.assembly, fact.border_loc, fact.nc)
        # local block solves (reference back solve pass 1,
        # explicit_schur_complement.py:144-148)
        with jax.named_scope("sc_solver.block_solve"):
            v = self._apply_blocks(fact, rhs.blocks, hi)
            if chain:
                sc_rhs = rhs.coupling - _border_apply_chain(
                    fact.border_loc, v, fact.nc, fact.group_offset
                )
            elif local:
                sc_rhs = rhs.coupling - _border_apply_local(
                    fact.border_loc, fact.row_idx, v, fact.nc
                )
            else:
                sc_rhs = rhs.coupling - jnp.einsum(
                    "bci,bi->c", fact.border, v, preferred_element_type=v.dtype
                )
        with jax.named_scope("sc_solver.sc_back_solve"):
            y = self.sc_solver.solve(fact.sc_fact, sc_rhs)
        # second block pass with the coupling solution substituted
        with jax.named_scope("sc_solver.back_solve"):
            if chain:
                rhs2 = rhs.blocks - _border_T_apply_chain(
                    fact.border_loc, y, fact.group_offset
                )
            elif local:
                rhs2 = rhs.blocks - _border_T_apply_local(
                    fact.border_loc, fact.row_idx, y
                )
            else:
                rhs2 = rhs.blocks - jnp.einsum(
                    "bci,c->bi", fact.border, y, preferred_element_type=v.dtype
                )
            x = self._apply_blocks(fact, rhs2, hi)
        return BlockRhs(blocks=x, coupling=y)

    def _solve_refined(self, fact: SchurFactor, rhs: BlockRhs):
        """(solution, refined_ok).  Adaptive mode iterates the refinement
        pass until the f32 residual probe passes (or ``refine_max_passes``
        is exhausted — refined_ok False then reports the stall): a single
        pass is not enough when rescued (signed-shift) factors contract
        the error only by ~sqrt(eps) per pass."""

        def up(b: BlockRhs) -> BlockRhs:  # promote to the rhs (f64) dtype
            return BlockRhs(
                blocks=b.blocks.astype(rhs.blocks.dtype),
                coupling=b.coupling.astype(rhs.coupling.dtype),
            )

        def refine_pass(x: BlockRhs, hi=False) -> BlockRhs:
            kx = _kkt_matvec(fact, x)
            r = BlockRhs(
                blocks=rhs.blocks - kx.blocks, coupling=rhs.coupling - kx.coupling
            )
            dx = up(self._solve_once(fact, r, hi))
            return BlockRhs(
                blocks=x.blocks + dx.blocks, coupling=x.coupling + dx.coupling
            )

        def solve_adaptive(hi):
            def cond(c):
                _, it, need = c
                return jnp.logical_and(need, it < self.refine_max_passes)

            def body(c):
                x, it, _ = c
                x = refine_pass(x, hi)
                return x, it + 1, _refine_probe(fact, rhs, x, self.refine_trigger)

            x = up(self._solve_once(fact, rhs, hi))
            need0 = _refine_probe(fact, rhs, x, self.refine_trigger)
            x, _, need = lax.while_loop(cond, body, (x, jnp.int32(0), need0))
            return x, need

        if self.adaptive_refine:
            x, need = solve_adaptive(False)
            if fact.block_W_hi is not None:
                # bf16 auto-gate: a refinement stall on the reduced-storage
                # W (apply error beyond the contraction threshold on
                # kappa-hard blocks) retries the whole solve with the
                # full-precision W instead of surfacing status=error
                def retry(_):
                    return solve_adaptive(True)

                def keep(_):
                    return x, need

                x, need = lax.cond(need, retry, keep, None)
            return x, jnp.logical_not(need)
        x = up(self._solve_once(fact, rhs))
        for _ in range(self.refine_steps):
            x = refine_pass(x)
        return x, jnp.asarray(True)

    def solve(self, fact: SchurFactor, rhs: BlockRhs) -> BlockRhs:
        return self._solve_refined(fact, rhs)[0]

    def solve_with_status(self, fact: SchurFactor, rhs: BlockRhs):
        x, ok = self._solve_refined(fact, rhs)
        status = jnp.maximum(
            self.status(fact),
            jnp.where(
                ok,
                jnp.int32(LinearSolverStatus.successful),
                jnp.int32(LinearSolverStatus.error),
            ),
        )
        return x, status

    def inertia(self, fact: SchurFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: SchurFactor) -> jax.Array:
        return fact.status
