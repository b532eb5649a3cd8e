"""Banded per-block factorization — the MA27 capability envelope for PDE
block families.

The reference factors *arbitrary sparse* symmetric-indefinite diagonal
blocks with multifrontal MA27
(/root/reference/parapint/linalg/ma27_interface.py:9-256), so its per-block
dimension is bounded by sparsity, not nk^2.  The dense batched LDL^T of
:mod:`parapint_tpu.linalg.schur` materializes (N, nk, nk) blocks — memory-
and flop-infeasible for the reference's own flagship scaling knob (Burgers
``--nfe_x`` beyond ~100, /root/reference/parapint/examples/burgers.py:14-20).

The answer here is not a multifrontal code (pointer-chasing
elimination trees are hostile to batched dense hardware); it is to exploit the structure
the PDE families actually have: under a bandwidth-reducing, constraint-
after-its-variables ordering (computed once per problem on the host, see
:mod:`parapint_tpu.interfaces.structured` banded mode), each per-block KKT
is *banded* with half-bandwidth p << nk.  A symmetric banded matrix tiled
into ts x ts tiles (ts >= p) IS block-tridiagonal, and a block-tridiagonal
symmetric-indefinite matrix factors by a batched block-Thomas LDL^T sweep:

- m = nk/ts sequential tile steps, each a *batched* (N, ts, ts) LDL^T
  (the existing fused factor kernels) plus two batched matmuls —
  O(N * nk * ts^2) total work and O(N * nk * ts) memory versus the dense
  path's O(N * nk^3) / O(N * nk^2).
- The sweep is sequential in tiles (unlike the coupling solver's cyclic
  reduction) because the per-block KKT is INDEFINITE: the ordering
  guarantees every constraint row is eliminated after its variables, so
  each tile's pivots see the accumulated Schur complement of everything
  before it — eliminating even tiles independently (cyclic reduction)
  would factor tiles whose standalone diagonal is structurally singular
  (a constraint row whose variables live in the previous tile).
- Inertia is EXACT by Haynsworth additivity over the sequential tile Schur
  complements — the IP inertia-correction contract is identical to the
  dense factorization's.

Everything downstream (Schur-complement formation over the coupling
border, chain-topology tile assembly, adaptive iterative refinement) is
shared with the dense solver's machinery.
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
from parapint_tpu.linalg.schur import (
    BlockRhs,
    _assemble_sc,
    _border_apply_chain,
    _border_apply_local,
    _border_T_apply_chain,
    _border_T_apply_local,
    _chain_border_ok,
    _chain_tiles,
    _factor_blocks_winv,
)
from parapint_tpu.linalg.tridiag import _winv_to_inverse
from parapint_tpu.ops.banded import (
    pad_sym_band,
    sym_band_to_tridiag_tiles,
    sym_banded_matvec,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BandedLocalBlockKKT:
    """Block-bordered KKT whose diagonal blocks are symmetric BANDED
    matrices in a precomputed fill-reducing permutation.

    sym_bands:  (N, p+1, nk) lower bands of the PERMUTED per-block KKTs
                (sym_bands[b, e, i] = Kp_b[i+e, i])
    border_loc: (N, L, nk) local border rows with PERMUTED columns
    row_idx:    (N, L) int32 global SC row of each local row
    q:          (nc, nc) coupling block
    mask:       (N,) 1.0 for logical blocks
    perm:       (nk,) int32 — permuted index i holds original index perm[i]
    iperm:      (nk,) int32 — inverse permutation
    assembly:   SC topology, as in LocalBlockKKT
    """

    sym_bands: jax.Array
    border_loc: jax.Array
    row_idx: jax.Array
    q: jax.Array
    mask: jax.Array
    perm: jax.Array
    iperm: jax.Array
    assembly: str = dataclasses.field(metadata=dict(static=True), default="scatter")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ThomasFactor:
    """Batched block-Thomas LDL^T factorization of N block-tridiagonal
    matrices: explicit tile inverses of the sequentially Schur-complemented
    diagonal tiles, plus the original superdiagonal tiles."""

    tinv: jax.Array  # (N, m, ts, ts)
    upper: jax.Array  # (N, m-1, ts, ts)
    inertia: jax.Array  # (3,) int32 (masked sum over blocks and tiles)
    status: jax.Array  # () int32


def thomas_factor_batched(
    diag_tiles: jax.Array,
    upper_tiles: jax.Array,
    mask: jax.Array,
    zero_tol: float = 0.0,
    factor_dtype=None,
    tile_block_size: int = 64,
) -> ThomasFactor:
    """Factor N block-tridiagonal matrices by a sequential tile sweep.

    diag_tiles (N, m, ts, ts), upper_tiles (N, m-1, ts, ts); each step
    factors the batched (N, ts, ts) Schur-complemented diagonal tile with
    the fused LDL^T + W kernel and carries U^T D'^{-1} U to the next tile.
    """
    N, m, ts, _ = diag_tiles.shape
    dt = diag_tiles.dtype

    def tile_step(carry, inputs):
        C = carry  # (N, ts, ts) Schur contribution from the previous tile
        D, U = inputs  # (N, ts, ts) diag tile, upper tile to the NEXT tile
        W, d, s, inert, stat = _factor_blocks_winv(
            D - C, mask, tile_block_size, zero_tol, factor_dtype
        )
        tinv = _winv_to_inverse(W, d, s, ts).astype(dt)
        tu = jnp.einsum("bij,bjk->bik", tinv, U, preferred_element_type=dt)
        C_next = jnp.einsum("bji,bjk->bik", U, tu, preferred_element_type=dt)
        return C_next, (tinv, inert, stat)

    # scan over the tile axis; last tile gets a zero upper
    d_seq = jnp.swapaxes(diag_tiles, 0, 1)  # (m, N, ts, ts)
    u_seq = jnp.concatenate(
        [jnp.swapaxes(upper_tiles, 0, 1), jnp.zeros((1, N, ts, ts), dtype=dt)],
        axis=0,
    )
    zero_c = jnp.zeros((N, ts, ts), dtype=dt)
    # the sweep is short (m = nk/ts ~ 8-16 steps); full unroll removes the
    # per-step loop-control latency and lets XLA overlap the independent
    # pieces of adjacent steps
    _, (tinv_seq, inert_seq, stat_seq) = lax.scan(
        tile_step, zero_c, (d_seq, u_seq), unroll=min(m, 8)
    )
    return ThomasFactor(
        tinv=jnp.swapaxes(tinv_seq, 0, 1),
        upper=upper_tiles,
        inertia=jnp.sum(inert_seq, axis=0),
        status=jnp.max(stat_seq),
    )


def thomas_solve_batched(fact: ThomasFactor, r: jax.Array) -> jax.Array:
    """Solve the N block-tridiagonal systems; r (N, m, ts) or (N, m, ts, k).

    Forward sweep  z_i = r_i - U_{i-1}^T Tinv_{i-1} z_{i-1},
    backward sweep x_i = Tinv_i z_i - Tinv_i U_i x_{i+1}.
    """
    vec = r.ndim == 3
    if vec:
        r = r[..., None]
    N, m, ts, k = r.shape
    dt = r.dtype
    tinv = jnp.swapaxes(fact.tinv, 0, 1).astype(dt)  # (m, N, ts, ts)
    upper = jnp.swapaxes(fact.upper, 0, 1).astype(dt)  # (m-1, N, ts, ts)
    u_prev = jnp.concatenate(
        [jnp.zeros((1, N, ts, ts), dtype=dt), upper], axis=0
    )  # u_prev[i] = U_{i-1}
    r_seq = jnp.swapaxes(r, 0, 1)  # (m, N, ts, k)

    def fwd(carry, inputs):
        tz_prev = carry  # Tinv_{i-1} z_{i-1}
        ri, Ti, Up = inputs
        z = ri - jnp.einsum("bji,bjk->bik", Up, tz_prev, preferred_element_type=dt)
        tz = jnp.einsum("bij,bjk->bik", Ti, z, preferred_element_type=dt)
        return tz, tz

    zero = jnp.zeros((N, ts, k), dtype=dt)
    _, tz_seq = lax.scan(fwd, zero, (r_seq, tinv, u_prev), unroll=min(m, 8))

    def bwd(carry, inputs):
        x_next = carry
        tzi, Ti, Ui = inputs  # Ui = U_i (to the next tile)
        x = tzi - jnp.einsum(
            "bij,bjk->bik",
            Ti,
            jnp.einsum("bij,bjk->bik", Ui, x_next, preferred_element_type=dt),
            preferred_element_type=dt,
        )
        return x, x

    u_next = jnp.concatenate(
        [upper, jnp.zeros((1, N, ts, ts), dtype=dt)], axis=0
    )
    _, x_rev = lax.scan(
        bwd, zero, (tz_seq, tinv, u_next), reverse=True, unroll=min(m, 8)
    )
    x = jnp.swapaxes(x_rev, 0, 1)  # (N, m, ts, k)
    return x[..., 0] if vec else x


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BandedSchurFactor:
    """Factorization state of :class:`BandedSchurComplementSolver`."""

    thomas: ThomasFactor
    sym_bands: object  # (N, p+1, nk) kept for the refinement matvec (or None)
    q: object  # (nc, nc) (or None)
    border_loc: jax.Array  # (N, L, nk) permuted columns
    row_idx: jax.Array
    perm: jax.Array
    iperm: jax.Array
    sc_fact: object
    inertia: jax.Array
    status: jax.Array
    nk: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))
    ts: int = dataclasses.field(metadata=dict(static=True))
    assembly: str = dataclasses.field(metadata=dict(static=True), default="scatter")
    # first global coupling group of this shard's blocks (sharded chain
    # path; None = 0)
    group_offset: object = None
    # (N, m, ts, ts) / (N, m-1, ts, ts) tile store of the (padded,
    # permuted) per-block KKTs — the refinement matvec runs in tile form
    # (see tridiag_tiles_matvec); None on hand-built factors falls back to
    # the shifted-band matvec
    diag_t: object = None
    upper_t: object = None
    # (N, nk, L) V = K^{-1} A^T from the SC formation.  The back solve is
    # x = K^{-1} r - V y_loc: one batched GEMM replaces the SECOND Thomas
    # sweep (16 sequential tile matvecs on the bench shape), in every
    # solve AND every refinement pass.  None disables (falls back to the
    # two-sweep form).
    v_border: object = None
    # scalar ||K||_F^2 of the full block-bordered system, precomputed at
    # numeric time: the refinement probe's noise floor becomes
    # (32 eps)^2 * ||K||_F^2 * ||x||^2 instead of a second |K||x| matvec
    # per probe (norm bound: || |K||x| ||_2 <= ||K||_F ||x||_2, so the
    # floor only grows — refinement stops earlier, never later than the
    # componentwise floor allowed).  None falls back to the matvec form.
    norm2: object = None


def _permute_cols(x: jax.Array, perm: jax.Array) -> jax.Array:
    """out[:, i] = x[:, perm[i]] via one-hot matmuls — BIT-EXACT.

    A one-hot selection matmul at precision="highest" is exact (products
    are x*1 or x*0, each row sums one nonzero), with the f64 input split
    3 ways into f32 (hi/mid/lo cover 72 >= 53 mantissa bits, so the
    recombination is the original double).  Whether this beats a plain
    gather on the GPU has not been measured.  BIT-EXACT for
    components |x| >= ~1e-23; below that the lo (then mid) split
    underflows the f32 subnormal range: relative error <= ~1e-12 down to
    |x| ~ 1e-29, and <= 2^-23 (~1e-7 relative, absolute <= |x| * 2^-23)
    for fully-subnormal-range components below — all far beneath the
    refinement floor (CPU-validated across 10^{+-25} dynamic range in
    tests/test_banded.py).  Inverse permutation = same matmul with the
    transposed one-hot (:func:`_permute_cols_inv`)."""
    nk = x.shape[-1]
    P = (perm[:, None] == jnp.arange(nk, dtype=perm.dtype)[None, :]).astype(
        jnp.float32
    )
    return _onehot_apply(x, P.T)


def _permute_cols_inv(x: jax.Array, perm: jax.Array) -> jax.Array:
    """out[:, perm[i]] = x[:, i] (inverse of :func:`_permute_cols`)."""
    nk = x.shape[-1]
    P = (perm[:, None] == jnp.arange(nk, dtype=perm.dtype)[None, :]).astype(
        jnp.float32
    )
    return _onehot_apply(x, P)


def _onehot_apply(x: jax.Array, Pt: jax.Array) -> jax.Array:
    f32 = jnp.float32
    if x.dtype == jnp.float64:
        hi = x.astype(f32)
        r1 = x - hi.astype(jnp.float64)
        mid = r1.astype(f32)
        lo = (r1 - mid.astype(jnp.float64)).astype(f32)
        out = jnp.zeros(x.shape, jnp.float64)
        for part in (hi, mid, lo):
            out = out + jnp.matmul(
                part, Pt, precision="highest", preferred_element_type=f32
            ).astype(jnp.float64)
        return out
    return jnp.matmul(
        x, Pt.astype(x.dtype), precision="highest", preferred_element_type=x.dtype
    )


def tridiag_tiles_matvec(diag_t, upper_t, x):
    """Batched block-tridiagonal matvec from the SAME tile store the Thomas
    factorization consumes: y_g = D_g x_g + U_g x_{g+1} + U_{g-1}^T x_{g-1}.

    diag_t (N, m, ts, ts), upper_t (N, m-1, ts, ts), x (N, m, ts) or
    (N, m, ts, k).  Three batched einsums total, where the per-diagonal
    shifted form (:func:`sym_banded_matvec`) issues ~2(p+1) dependent
    vector ops.  Also the f64 refinement matvec path.
    """
    vec = x.ndim == 3
    if vec:
        x = x[..., None]
    dt = x.dtype
    y = jnp.einsum(
        "bmij,bmjk->bmik", diag_t.astype(dt), x, preferred_element_type=dt
    )
    if upper_t.shape[1]:
        u = upper_t.astype(dt)
        y = y.at[:, :-1].add(
            jnp.einsum(
                "bmij,bmjk->bmik", u, x[:, 1:], preferred_element_type=dt
            )
        )
        y = y.at[:, 1:].add(
            jnp.einsum(
                "bmji,bmjk->bmik", u, x[:, :-1], preferred_element_type=dt
            )
        )
    return y[..., 0] if vec else y


def _banded_block_matvec(sym_bands, x, dtype=None):
    """K_b x_b per block via the banded stencil; x (N, nk) PERMUTED."""
    if dtype is not None:
        sym_bands = sym_bands.astype(dtype)
        x = x.astype(dtype)
    return jax.vmap(sym_banded_matvec)(sym_bands, x)


def banded_tiles(sym_bands: jax.Array, tile_size=None):
    """(diag_tiles, upper_tiles, ts, nk_pad) from a batched band store
    (N, p+1, nk); pads nk to a tile multiple with identity rows."""
    N, pp1, nk = sym_bands.shape
    p = pp1 - 1
    ts = tile_size if tile_size is not None else max(8, p)
    if ts < p:
        raise ValueError(f"tile_size {ts} < half-bandwidth {p}")
    n_extra = (-nk) % ts
    nk_pad = nk + n_extra
    if n_extra:
        pad = jnp.zeros((N, pp1, n_extra), dtype=sym_bands.dtype)
        pad = pad.at[:, 0, :].set(1.0)
        bands = jnp.concatenate([sym_bands, pad], axis=2)
    else:
        bands = sym_bands
    diag_t, upper_t = jax.vmap(lambda sb: sym_band_to_tridiag_tiles(sb, ts))(
        bands
    )
    return diag_t, upper_t, ts, nk_pad


def pad_banded_block_count(kkt: BandedLocalBlockKKT, multiple: int):
    """Pad a BandedLocalBlockKKT to a multiple of ``multiple`` blocks with
    masked identity blocks (band 0 = 1, zero borders); chain assemblies
    fall back to scatter exactly as :func:`parapint_tpu.linalg.schur.
    pad_block_count` does (padding blocks overflow the chain windows)."""
    N, pp1, nk = kkt.sym_bands.shape
    rem = (-N) % multiple
    if rem == 0:
        return kkt
    pad = jnp.zeros((rem, pp1, nk), dtype=kkt.sym_bands.dtype)
    pad = pad.at[:, 0, :].set(1.0)
    L = kkt.border_loc.shape[1]
    nc = kkt.q.shape[-1]
    return BandedLocalBlockKKT(
        sym_bands=jnp.concatenate([kkt.sym_bands, pad], axis=0),
        border_loc=jnp.concatenate(
            [kkt.border_loc, jnp.zeros((rem, L, nk), dtype=kkt.border_loc.dtype)],
            axis=0,
        ),
        row_idx=jnp.concatenate(
            [kkt.row_idx, jnp.full((rem, L), nc, dtype=jnp.int32)], axis=0
        ),
        q=kkt.q,
        mask=jnp.concatenate(
            [kkt.mask, jnp.zeros(rem, dtype=kkt.mask.dtype)]
        ),
        perm=kkt.perm,
        iperm=kkt.iperm,
        assembly="scatter" if kkt.assembly == "chain" else kkt.assembly,
    )


class BandedSchurComplementSolver(LinearSolver):
    """Schur-complement solver with BANDED per-block factorization.

    Consumes a :class:`BandedLocalBlockKKT` (produced by the structured
    interfaces in ``block_form="banded"`` mode).  Per-block memory is
    O(nk * ts) and per-block factor work O(nk * ts^2) — the batched
    equivalent of the reference's MA27 sparse capability envelope for
    banded (PDE-discretization) block families.

    ``rhs``/solutions use the ORIGINAL variable ordering (BlockRhs, as the
    dense solvers); permutation happens internally.
    """

    def __init__(
        self,
        schur_complement_solver: Optional[LinearSolver] = None,
        tile_size: Optional[int] = None,
        zero_tol: float = 0.0,
        factor_dtype=None,
        refine_steps: Optional[int] = None,
        refine_trigger: float = 1e-5,
        refine_max_passes: int = 8,
        tile_block_size: int = 64,
    ):
        self.sc_solver = (
            schur_complement_solver
            if schur_complement_solver is not None
            else DenseLDLSolver(zero_tol=zero_tol, refine_steps=0)
        )
        self.tile_size = tile_size
        self.zero_tol = zero_tol
        self.factor_dtype = factor_dtype
        self.adaptive_refine = refine_steps is None
        self.refine_steps = 1 if refine_steps is None else refine_steps
        self.refine_trigger = refine_trigger
        self.refine_max_passes = refine_max_passes
        # panel width of the per-tile LDL^T inside the Thomas sweep; the
        # tile factors ts x ts blocks, so tile_block_size=ts runs ONE fused
        # panel kernel per tile instead of ts/tile_block_size chained ones
        self.tile_block_size = tile_block_size

    # -- factorization ------------------------------------------------------

    def _tiles(self, kkt: BandedLocalBlockKKT):
        """(diag_tiles, upper_tiles, ts, nk_pad) from the banded store."""
        return banded_tiles(kkt.sym_bands, self.tile_size)

    def symbolic(self, kkt: BandedLocalBlockKKT) -> LinearSolverResults:
        N, pp1, nk = kkt.sym_bands.shape
        if kkt.border_loc.shape[0] != N or kkt.border_loc.shape[2] != nk:
            raise ValueError(
                f"border_loc shape {kkt.border_loc.shape} inconsistent with "
                f"sym_bands {kkt.sym_bands.shape}"
            )
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def _use_tridiag_sc(self, kkt) -> bool:
        from parapint_tpu.linalg.tridiag import BlockTridiagSolver

        if not isinstance(self.sc_solver, BlockTridiagSolver):
            return False
        if kkt.assembly != "chain":
            return False
        ns = kkt.border_loc.shape[1] // 2
        nc = kkt.q.shape[-1]
        return ns > 0 and nc > 0 and nc % ns == 0

    def numeric(self, kkt: BandedLocalBlockKKT) -> BandedSchurFactor:
        from parapint_tpu.linalg.tridiag import BlockTridiag, extract_tridiag

        N, pp1, nk = kkt.sym_bands.shape
        nc = kkt.q.shape[-1]
        tridiag = self._use_tridiag_sc(kkt)
        ns = kkt.border_loc.shape[1] // 2
        with jax.named_scope("banded_sc.factor_blocks"):
            diag_t, upper_t, ts, nk_pad = self._tiles(kkt)
            thomas = thomas_factor_batched(
                diag_t,
                upper_t,
                kkt.mask,
                zero_tol=self.zero_tol,
                factor_dtype=self.factor_dtype,
                tile_block_size=self.tile_block_size,
            )
        with jax.named_scope("banded_sc.form_sc"):
            # V = K^{-1} A^T over the L border columns (multi-RHS sweep)
            A = kkt.border_loc  # (N, L, nk)
            L = A.shape[1]
            At = jnp.swapaxes(A, 1, 2).astype(diag_t.dtype)  # (N, nk, L)
            if nk_pad != nk:
                At = jnp.pad(At, ((0, 0), (0, nk_pad - nk), (0, 0)))
            V = thomas_solve_batched(
                thomas, At.reshape(N, nk_pad // ts, ts, L)
            ).reshape(N, nk_pad, L)[:, :nk]
            S_loc = jnp.einsum(
                "bli,bik->blk",
                A.astype(V.dtype),
                V,
                preferred_element_type=V.dtype,
            )
            S_loc = S_loc * kkt.mask[:, None, None].astype(V.dtype)
            if tridiag:
                dt_c, ut_full = _chain_tiles(S_loc, nc)
                q_tri = extract_tridiag(kkt.q.astype(V.dtype), ns)
                sc = BlockTridiag(
                    diag=q_tri.diag - dt_c, upper=q_tri.upper - ut_full[:-1]
                )
            else:
                sc = kkt.q.astype(V.dtype) - _assemble_sc(
                    S_loc, kkt.row_idx, nc, kkt.assembly
                )
        with jax.named_scope("banded_sc.factor_sc"):
            sc_fact = self.sc_solver.numeric(sc)
        f32 = jnp.float32
        norm2 = (
            jnp.sum(diag_t.astype(f32) ** 2)
            + 2.0 * jnp.sum(upper_t.astype(f32) ** 2)
            + 2.0 * jnp.sum(kkt.border_loc.astype(f32) ** 2)
            + jnp.sum(kkt.q.astype(f32) ** 2)
        )
        sc_pos, sc_neg, sc_zero = self.sc_solver.inertia(sc_fact)
        # structural identity padding rows contribute +1 pivots each —
        # subtract them so the inertia matches the logical dimension
        n_extra = nk_pad - nk
        n_logical = jnp.sum(kkt.mask).astype(jnp.int32)
        pad_pos = jnp.int32(n_extra) * n_logical
        inertia = thomas.inertia + jnp.stack([sc_pos, sc_neg, sc_zero])
        inertia = inertia.at[0].add(-pad_pos)
        status = jnp.maximum(thomas.status, self.sc_solver.status(sc_fact))
        keep = True
        return BandedSchurFactor(
            thomas=thomas,
            sym_bands=kkt.sym_bands if keep else None,
            q=kkt.q if keep else None,
            border_loc=kkt.border_loc,
            row_idx=kkt.row_idx,
            perm=kkt.perm,
            iperm=kkt.iperm,
            sc_fact=sc_fact,
            inertia=inertia,
            status=status,
            nk=nk,
            nc=nc,
            ts=ts,
            assembly=kkt.assembly,
            diag_t=diag_t,
            upper_t=upper_t,
            v_border=V,
            norm2=norm2,
        )

    # -- solves -------------------------------------------------------------

    def _apply_blocks(self, fact: BandedSchurFactor, b):
        """K_b^{-1} b_b per block; b (N, nk) PERMUTED -> (N, nk) permuted."""
        N, nk = b.shape
        ts = fact.ts
        nk_pad = -(-nk // ts) * ts
        dt = fact.thomas.tinv.dtype
        bp = b.astype(dt)
        if nk_pad != nk:
            bp = jnp.pad(bp, ((0, 0), (0, nk_pad - nk)))
        x = thomas_solve_batched(
            fact.thomas, bp.reshape(N, nk_pad // ts, ts)
        ).reshape(N, nk_pad)
        return x[:, :nk]

    def _solve_once(self, fact: BandedSchurFactor, rhs: BlockRhs) -> BlockRhs:
        """One SC solve in PERMUTED block coordinates."""
        from parapint_tpu.linalg.schur import _border_y_loc_chain

        chain = _chain_border_ok(fact.assembly, fact.border_loc, fact.nc)
        with jax.named_scope("banded_sc.block_solve"):
            v = self._apply_blocks(fact, rhs.blocks)
            if chain:
                sc_rhs = rhs.coupling - _border_apply_chain(
                    fact.border_loc, v, fact.nc, fact.group_offset
                )
            else:
                sc_rhs = rhs.coupling - _border_apply_local(
                    fact.border_loc, fact.row_idx, v, fact.nc
                )
        with jax.named_scope("banded_sc.sc_back_solve"):
            # coupling solve at the FACTOR precision: the block part already
            # runs f32 (thomas tinv) and the refinement loop owns the f64
            # story, so an f64 CR sweep here (~55 small f64 matvecs) buys
            # nothing
            fdt = fact.thomas.tinv.dtype
            y = self.sc_solver.solve(fact.sc_fact, sc_rhs.astype(fdt))
        with jax.named_scope("banded_sc.back_solve"):
            if fact.v_border is not None:
                # x = K^{-1} rhs - V y_loc: the second Thomas sweep folds
                # into one batched GEMM against the stored V = K^{-1} A^T
                Nb, L = fact.border_loc.shape[:2]
                yv = y.astype(fact.v_border.dtype)
                if chain:
                    y_loc = _border_y_loc_chain(yv, Nb, L, fact.group_offset)
                else:
                    y_pad = jnp.concatenate(
                        [yv, jnp.zeros(1, dtype=yv.dtype)]
                    )
                    y_loc = y_pad[fact.row_idx]
                x = v - jnp.matmul(
                    fact.v_border, y_loc[:, :, None],
                    preferred_element_type=v.dtype,
                )[..., 0]
            else:
                if chain:
                    rhs2 = rhs.blocks - _border_T_apply_chain(
                        fact.border_loc, y, fact.group_offset
                    )
                else:
                    rhs2 = rhs.blocks - _border_T_apply_local(
                        fact.border_loc, fact.row_idx, y
                    )
                x = self._apply_blocks(fact, rhs2)
        return BlockRhs(blocks=x, coupling=y)

    def _kkt_matvec(
        self, fact: BandedSchurFactor, x: BlockRhs, dtype=None, psum_axis=None
    ):
        """K @ x (permuted block coords) for iterative refinement.  With
        ``psum_axis`` the coupling part reduces over the mesh axis
        (shard_map context)."""
        q = fact.q
        xb, xc = x.blocks, x.coupling
        border_loc = fact.border_loc
        if dtype is not None:
            q = q.astype(dtype)
            xb = xb.astype(dtype)
            xc = xc.astype(dtype)
            border_loc = border_loc.astype(dtype)
        if fact.diag_t is not None:
            N, nk = xb.shape
            ts = fact.ts
            nk_pad = fact.diag_t.shape[1] * ts
            xp = (
                jnp.pad(xb, ((0, 0), (0, nk_pad - nk)))
                if nk_pad != nk
                else xb
            )
            bx = tridiag_tiles_matvec(
                fact.diag_t, fact.upper_t, xp.reshape(N, nk_pad // ts, ts)
            ).reshape(N, nk_pad)[:, :nk]
        else:
            bands = fact.sym_bands
            if dtype is not None:
                bands = bands.astype(dtype)
            bx = _banded_block_matvec(bands, xb)
        if _chain_border_ok(fact.assembly, border_loc, fact.nc):
            bx = bx + _border_T_apply_chain(border_loc, xc, fact.group_offset)
            cy = _border_apply_chain(border_loc, xb, fact.nc, fact.group_offset)
        else:
            bx = bx + _border_T_apply_local(border_loc, fact.row_idx, xc)
            cy = _border_apply_local(border_loc, fact.row_idx, xb, fact.nc)
        if psum_axis is not None:
            cy = jax.lax.psum(cy, psum_axis)
        cy = cy + jnp.matmul(q, xc, preferred_element_type=cy.dtype)
        return BlockRhs(blocks=bx, coupling=cy)

    def _refine_probe(self, fact, rhs, x, trigger, psum_axis=None):
        """f32 residual check, same semantics as the dense solver's
        (schur.py _refine_probe) with the banded matvec.  With
        ``psum_axis`` the block norms reduce over the mesh axis (the
        coupling part is shard-replicated and is added once)."""
        f32 = jnp.float32
        kx = self._kkt_matvec(fact, x, dtype=f32, psum_axis=psum_axis)
        wd = rhs.blocks.dtype
        rb = rhs.blocks.astype(f32).astype(wd) - kx.blocks.astype(wd)
        rc = rhs.coupling.astype(f32).astype(wd) - kx.coupling.astype(wd)
        rb2 = jnp.sum(rb * rb)
        bb2 = jnp.sum(rhs.blocks.astype(wd) ** 2)
        if fact.norm2 is not None:
            # precomputed-||K||_F floor (see the norm2 field note): only
            # ||x||^2 is needed per probe
            xb2 = jnp.sum(x.blocks.astype(wd) ** 2)
            if psum_axis is not None:
                rb2 = jax.lax.psum(rb2, psum_axis)
                bb2 = jax.lax.psum(bb2, psum_axis)
                xb2 = jax.lax.psum(xb2, psum_axis)
            fn2 = fact.norm2.astype(wd) * (
                xb2 + jnp.sum(x.coupling.astype(wd) ** 2)
            )
        else:
            # |K| matvec noise floor: every tile entry is a single band
            # entry (positional placement), so abs commutes with the tiling
            afact = dataclasses.replace(
                fact,
                sym_bands=None
                if fact.sym_bands is None
                else jnp.abs(fact.sym_bands),
                q=jnp.abs(fact.q),
                border_loc=jnp.abs(fact.border_loc),
                diag_t=None if fact.diag_t is None else jnp.abs(fact.diag_t),
                upper_t=None if fact.upper_t is None else jnp.abs(fact.upper_t),
            )
            ax = BlockRhs(
                blocks=jnp.abs(x.blocks), coupling=jnp.abs(x.coupling)
            )
            kabs = self._kkt_matvec(afact, ax, dtype=f32, psum_axis=psum_axis)
            fb2 = jnp.sum(kabs.blocks.astype(wd) ** 2)
            if psum_axis is not None:
                rb2 = jax.lax.psum(rb2, psum_axis)
                bb2 = jax.lax.psum(bb2, psum_axis)
                fb2 = jax.lax.psum(fb2, psum_axis)
            fn2 = fb2 + jnp.sum(kabs.coupling.astype(wd) ** 2)
        rn2 = rb2 + jnp.sum(rc * rc)
        bn2 = bb2 + jnp.sum(rhs.coupling.astype(wd) ** 2)
        eps = 32.0 * np.finfo(np.float32).eps
        floor2 = (eps * eps) * fn2
        bad = jnp.logical_not(jnp.isfinite(rn2))
        return jnp.logical_or(
            bad,
            rn2 > jnp.maximum((trigger * trigger) * jnp.maximum(1.0, bn2), floor2),
        )

    def _solve_refined(self, fact: BandedSchurFactor, rhs: BlockRhs):
        # permute the rhs blocks into the banded ordering once
        rp = BlockRhs(
            blocks=_permute_cols(rhs.blocks, fact.perm),
            coupling=rhs.coupling,
        )

        def up(b: BlockRhs) -> BlockRhs:
            return BlockRhs(
                blocks=b.blocks.astype(rp.blocks.dtype),
                coupling=b.coupling.astype(rp.coupling.dtype),
            )

        def refine_pass(x: BlockRhs) -> BlockRhs:
            kx = self._kkt_matvec(fact, x)
            r = BlockRhs(
                blocks=rp.blocks - kx.blocks, coupling=rp.coupling - kx.coupling
            )
            dx = up(self._solve_once(fact, r))
            return BlockRhs(
                blocks=x.blocks + dx.blocks, coupling=x.coupling + dx.coupling
            )

        x = up(self._solve_once(fact, rp))
        if self.adaptive_refine:
            def cond(c):
                _, it, need = c
                return jnp.logical_and(need, it < self.refine_max_passes)

            def body(c):
                xx, it, _ = c
                xx = refine_pass(xx)
                return xx, it + 1, self._refine_probe(fact, rp, xx, self.refine_trigger)

            need0 = self._refine_probe(fact, rp, x, self.refine_trigger)
            x, _, need = lax.while_loop(cond, body, (x, jnp.int32(0), need0))
            ok = jnp.logical_not(need)
        else:
            for _ in range(self.refine_steps):
                x = refine_pass(x)
            ok = jnp.asarray(True)
        # un-permute the block solution
        xb = _permute_cols_inv(x.blocks, fact.perm)
        return BlockRhs(blocks=xb, coupling=x.coupling), ok

    def solve(self, fact: BandedSchurFactor, rhs: BlockRhs) -> BlockRhs:
        return self._solve_refined(fact, rhs)[0]

    def solve_with_status(self, fact: BandedSchurFactor, rhs: BlockRhs):
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

    def inertia(self, fact: BandedSchurFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: BandedSchurFactor) -> jax.Array:
        return fact.status


class ShardedBandedSchurComplementSolver(BandedSchurComplementSolver):
    """Banded per-block factorization with the block axis sharded over a
    mesh axis — the multi-device MA27-envelope path: each shard runs the
    block-Thomas sweep on its owned blocks' bands, the Schur complement is
    psum-reduced and factorized replicated (identical math to
    :class:`parapint_tpu.linalg.sharded_schur.ShardedSchurComplementSolver`,
    reference mpi_explicit_schur_complement.py:128-452).
    """

    def __init__(self, mesh, axis_name: str = "blocks", **kw):
        super().__init__(**kw)
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_shards = mesh.shape[axis_name]

    def numeric(self, kkt: BandedLocalBlockKKT) -> BandedSchurFactor:
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        from parapint_tpu.linalg.tridiag import BlockTridiag, extract_tridiag

        ax = self.axis_name
        kkt = pad_banded_block_count(kkt, self.n_shards)
        N, pp1, nk = kkt.sym_bands.shape
        nc = kkt.q.shape[-1]
        tridiag = self._use_tridiag_sc(kkt)
        ns = kkt.border_loc.shape[1] // 2
        assembly = kkt.assembly

        def _numeric(bands, border, row_idx, q, mask):
            offset = lax.axis_index(ax) * bands.shape[0]
            with jax.named_scope("banded_sc.factor_blocks"):
                diag_t, upper_t, ts, nk_pad = banded_tiles(
                    bands, self.tile_size
                )
                thomas = thomas_factor_batched(
                    diag_t, upper_t, mask,
                    zero_tol=self.zero_tol, factor_dtype=self.factor_dtype,
                    tile_block_size=self.tile_block_size,
                )
            with jax.named_scope("banded_sc.form_sc"):
                Nl = bands.shape[0]
                L = border.shape[1]
                At = jnp.swapaxes(border, 1, 2).astype(diag_t.dtype)
                if nk_pad != nk:
                    At = jnp.pad(At, ((0, 0), (0, nk_pad - nk), (0, 0)))
                V = thomas_solve_batched(
                    thomas, At.reshape(Nl, nk_pad // ts, ts, L)
                ).reshape(Nl, nk_pad, L)[:, :nk]
                S_loc = jnp.einsum(
                    "bli,bik->blk", border.astype(V.dtype), V,
                    preferred_element_type=V.dtype,
                ) * mask[:, None, None].astype(V.dtype)
                v_border = V
            with jax.named_scope("banded_sc.communicate"):
                if tridiag:
                    dt_c, ut_full = _chain_tiles(S_loc, nc, offset)
                    q_tri = extract_tridiag(q.astype(V.dtype), ns)
                    sc = BlockTridiag(
                        diag=q_tri.diag - lax.psum(dt_c, ax),
                        upper=q_tri.upper - lax.psum(ut_full[:-1], ax),
                    )
                else:
                    contrib = _assemble_sc(
                        S_loc, row_idx, nc, assembly, offset
                    )
                    sc = q.astype(V.dtype) - lax.psum(contrib, ax)
                blk_inertia = lax.psum(thomas.inertia, ax)
                blk_status = lax.pmax(thomas.status, ax)
                f32l = jnp.float32
                norm2 = lax.psum(
                    jnp.sum(diag_t.astype(f32l) ** 2)
                    + 2.0 * jnp.sum(upper_t.astype(f32l) ** 2)
                    + 2.0 * jnp.sum(border.astype(f32l) ** 2),
                    ax,
                ) + jnp.sum(q.astype(f32l) ** 2)
            with jax.named_scope("banded_sc.factor_sc"):
                sc_fact = self.sc_solver.numeric(sc)
            sc_pos, sc_neg, sc_zero = self.sc_solver.inertia(sc_fact)
            n_extra = nk_pad - nk
            n_logical = jnp.sum(mask).astype(jnp.int32)
            pad_pos = lax.psum(jnp.int32(n_extra) * n_logical, ax)
            inertia = blk_inertia + jnp.stack([sc_pos, sc_neg, sc_zero])
            inertia = inertia.at[0].add(-pad_pos)
            status = jnp.maximum(blk_status, self.sc_solver.status(sc_fact))
            # replace the thomas diagnostics with the REDUCED values so the
            # returned pytree is shard-replicated where its out_specs say so
            thomas = dataclasses.replace(
                thomas, inertia=blk_inertia, status=blk_status
            )
            return (
                thomas, sc_fact, inertia, status, diag_t, upper_t, v_border,
                norm2,
            )

        thomas_specs = ThomasFactor(
            tinv=P(ax), upper=P(ax), inertia=P(), status=P()
        )
        if tridiag:
            sc_struct = self.sc_solver.fact_struct(
                nc // ns, ns, kkt.sym_bands.dtype
            )
        else:
            sc_struct = jax.eval_shape(
                self.sc_solver.numeric,
                jax.ShapeDtypeStruct((nc, nc), kkt.sym_bands.dtype),
            )
        sc_fact_specs = jax.tree_util.tree_map(lambda _: P(), sc_struct)
        (
            thomas, sc_fact, inertia, status, diag_t, upper_t, v_border,
            norm2,
        ) = shard_map(
            _numeric,
            mesh=self.mesh,
            in_specs=(P(ax), P(ax), P(ax), P(), P(ax)),
            out_specs=(
                thomas_specs, sc_fact_specs, P(), P(), P(ax), P(ax), P(ax),
                P(),
            ),
            check_vma=False,
        )(kkt.sym_bands, kkt.border_loc, kkt.row_idx, kkt.q, kkt.mask)
        ts = self.tile_size if self.tile_size is not None else max(8, pp1 - 1)
        return BandedSchurFactor(
            thomas=thomas,
            sym_bands=kkt.sym_bands,
            q=kkt.q,
            border_loc=kkt.border_loc,
            row_idx=kkt.row_idx,
            perm=kkt.perm,
            iperm=kkt.iperm,
            sc_fact=sc_fact,
            inertia=inertia,
            status=status,
            nk=nk,
            nc=nc,
            ts=ts,
            assembly=assembly,
            diag_t=diag_t,
            upper_t=upper_t,
            v_border=v_border,
            norm2=norm2,
        )

    def _solve_refined(self, fact: BandedSchurFactor, rhs: BlockRhs):
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        ax = self.axis_name
        nb = fact.sym_bands.shape[0]
        n_rhs = rhs.blocks.shape[0]
        # permute into the banded ordering, pad to the factor's block count
        rp = _permute_cols(rhs.blocks, fact.perm)
        if n_rhs != nb:
            rp = jnp.pad(rp, ((0, nb - n_rhs), (0, 0)))

        def _solve(
            thomas, bands, border, row_idx, q, sc_fact, blocks, coupling,
            diag_t, upper_t, v_border, norm2,
        ):
            offset = lax.axis_index(ax) * blocks.shape[0]
            shard_fact = BandedSchurFactor(
                thomas=thomas,
                sym_bands=bands,
                q=q,
                border_loc=border,
                row_idx=row_idx,
                perm=fact.perm,
                iperm=fact.iperm,
                sc_fact=sc_fact,
                inertia=None,
                status=None,
                nk=fact.nk,
                nc=fact.nc,
                ts=fact.ts,
                assembly=fact.assembly,
                group_offset=offset,
                diag_t=diag_t,
                upper_t=upper_t,
                v_border=v_border,
                norm2=norm2,
            )
            lrhs = BlockRhs(blocks=blocks, coupling=coupling)

            def solve_once(r):
                from parapint_tpu.linalg.schur import _border_y_loc_chain

                chain = _chain_border_ok(fact.assembly, border, fact.nc)
                v = self._apply_blocks(shard_fact, r.blocks)
                if chain:
                    contrib = _border_apply_chain(border, v, fact.nc, offset)
                else:
                    contrib = _border_apply_local(
                        border, row_idx, v, fact.nc
                    )
                sc_rhs = r.coupling - lax.psum(contrib, ax)
                # factor-precision coupling solve (see the serial
                # _solve_once note)
                y = self.sc_solver.solve(
                    sc_fact, sc_rhs.astype(thomas.tinv.dtype)
                )
                Nb, L = border.shape[:2]
                yv = y.astype(v_border.dtype)
                if chain:
                    y_loc = _border_y_loc_chain(yv, Nb, L, offset)
                else:
                    y_pad = jnp.concatenate(
                        [yv, jnp.zeros(1, dtype=yv.dtype)]
                    )
                    y_loc = y_pad[row_idx]
                x = v - jnp.matmul(
                    v_border, y_loc[:, :, None],
                    preferred_element_type=v.dtype,
                )[..., 0]
                return BlockRhs(blocks=x, coupling=y)

            def up(b):
                return BlockRhs(
                    blocks=b.blocks.astype(blocks.dtype),
                    coupling=b.coupling.astype(coupling.dtype),
                )

            x = up(solve_once(lrhs))
            if not self.adaptive_refine:
                for _ in range(self.refine_steps):
                    kx = self._kkt_matvec(shard_fact, x, psum_axis=ax)
                    r = BlockRhs(
                        blocks=blocks - kx.blocks,
                        coupling=coupling - kx.coupling,
                    )
                    dx = up(solve_once(r))
                    x = BlockRhs(
                        blocks=x.blocks + dx.blocks,
                        coupling=x.coupling + dx.coupling,
                    )
                return x.blocks, x.coupling, jnp.asarray(True)

            def probe(xv):
                return self._refine_probe(
                    shard_fact, lrhs, xv, self.refine_trigger, psum_axis=ax
                )

            def cond(c):
                _, it, need = c
                return jnp.logical_and(need, it < self.refine_max_passes)

            def body(c):
                xv, it, _ = c
                kx = self._kkt_matvec(shard_fact, xv, psum_axis=ax)
                r = BlockRhs(
                    blocks=blocks - kx.blocks, coupling=coupling - kx.coupling
                )
                dx = up(solve_once(r))
                xv = BlockRhs(
                    blocks=xv.blocks + dx.blocks,
                    coupling=xv.coupling + dx.coupling,
                )
                return xv, it + 1, probe(xv)

            x, _, need = lax.while_loop(cond, body, (x, jnp.int32(0), probe(x)))
            return x.blocks, x.coupling, jnp.logical_not(need)

        thomas_specs = ThomasFactor(
            tinv=P(ax), upper=P(ax), inertia=P(), status=P()
        )
        sc_fact_specs = jax.tree_util.tree_map(lambda _: P(), fact.sc_fact)
        xb, y, ok = shard_map(
            _solve,
            mesh=self.mesh,
            in_specs=(
                thomas_specs, P(ax), P(ax), P(ax), P(), sc_fact_specs,
                P(ax), P(), P(ax), P(ax), P(ax), P(),
            ),
            out_specs=(P(ax), P(), P()),
            check_vma=False,
        )(
            fact.thomas,
            fact.sym_bands,
            fact.border_loc,
            fact.row_idx,
            fact.q,
            fact.sc_fact,
            rp,
            rhs.coupling,
            fact.diag_t,
            fact.upper_t,
            fact.v_border,
            fact.norm2,
        )
        xb = _permute_cols_inv(xb[:n_rhs], fact.perm)
        return BlockRhs(blocks=xb, coupling=y), ok
