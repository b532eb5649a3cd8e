"""Condensed structured solver for large banded least-squares blocks.

The reference's performance harness factors per-block KKTs of ~600k
variables with MA27 — sparse multifrontal — at defaults
``n_q_per_block=5000, n_y_multiplier=120``
(/root/reference/parapint/examples/performance/schur_complement/main.py:63-73).
Each block is the least-squares saddle system (create_model.py:23-47), here
in the quasi-definite [y, nu, q, lam] ordering::

    [2I   I    0    0  ] [y  ]   [b_y  ]      y:  n_y = n_mult * n_q
    [I    0   -A    0  ] [nu ] = [b_nu ]      nu: n_y   (dual of y = A q)
    [0   -A^T  0    P^T] [q  ]   [b_q  ]      q:  n_q
    [0    0    P    0  ] [lam]   [b_lam]      lam: n_t  (dual of P q = theta)

with A a vertical stack of n_mult banded (n_q x n_q) matrices and P the
selector of the first n_t entries of q.  A dense batched factorization is
O(nk^2) memory — hopeless at this scale.  Instead of translating MA27's
elimination trees (pointer-chasing, hostile to batched dense hardware), this solver eliminates
y and nu *analytically*::

    y  = A q + b_nu,        nu = b_y - 2 y,

leaving the condensed saddle system in (q, lam)::

    [G    P^T] [q  ]   [b_q + A^T b_y - 2 A^T b_nu]        G = 2 A^T A
    [P    0  ] [lam] = [b_lam]

G is symmetric positive definite and *banded* (half-bandwidth 2p for A-bands
of half-bandwidth p), so tiled into ts x ts tiles it is block-tridiagonal
and factors by the batched cyclic reduction of
:mod:`parapint_tpu.linalg.tridiag` — O(n_q p^2) memory and O(n_q ts^2)
flops, independent of n_y.  lam is recovered through the small dense
Schur complement S_lam = -P G^{-1} P^T, and the global coupling (theta)
through S_theta = Q - sum_i S_lam_i^{-1} exactly as in the explicit
Schur-complement solvers.

Inertia is exact by Haynsworth additivity:
inertia(K_i) = (n_y, n_y, 0)             [the (y, nu) hyperbolic pair]
             + inertia(G)                [cyclic-reduction pivots]
             + inertia(S_lam)            [dense LDL of the nt x nt tile].

A and P are shared across blocks (the reference harness builds ONE A,
create_model.py:79-91); per-block data is the right-hand side.  The
per-block solve is a handful of banded stencils + one batched
cyclic-reduction solve, so blocks of *millions* of variables run on one
device.
"""

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from parapint_tpu.linalg.base import LinearSolver
from parapint_tpu.linalg.dense import DenseLDLSolver
from parapint_tpu.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu.linalg.schur import BlockRhs
from parapint_tpu.linalg.tridiag import BlockTridiag, cr_factor, cr_solve
from parapint_tpu.ops.banded import (
    banded_btb,
    banded_matvec,
    banded_rmatvec,
    pad_sym_band,
    sym_band_to_tridiag_tiles,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CondensedLSQKKT:
    """The N-block structured least-squares KKT, never densified.

    A_bands: (n_mult, 2p+1, n_q) row-indexed bands of the stacked banded
             blocks B_j of A (A = vstack(B_0..B_{n_mult-1})), shared across
             blocks.
    n_t:     coupling dimension (P = first-n_t-rows selector).
    q_c:     (n_t, n_t) global coupling block Q (zero in the harness).
    n_blocks: number of blocks N.
    """

    A_bands: jax.Array
    q_c: jax.Array
    n_t: int = dataclasses.field(metadata=dict(static=True))
    n_blocks: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_q(self) -> int:
        return self.A_bands.shape[-1]

    @property
    def n_mult(self) -> int:
        return self.A_bands.shape[0]

    @property
    def n_y(self) -> int:
        return self.n_mult * self.n_q

    @property
    def nk(self) -> int:
        """Full per-block dimension in the [y, nu, q, lam] layout (the
        quasi-definite ordering the dense batched solvers also use)."""
        return 2 * self.n_y + self.n_q + self.n_t

    # offsets in the full per-block vector layout
    @property
    def off_nu(self) -> int:
        return self.n_y

    @property
    def off_q(self) -> int:
        return 2 * self.n_y

    @property
    def off_lam(self) -> int:
        return 2 * self.n_y + self.n_q


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CondensedFactor:
    g_fact: object  # cyclic-reduction factor of padded G
    pinv_cols: jax.Array  # (n_q, n_t)  G^{-1} P^T
    s_lam_fact: object  # dense factor of S_lam = -P G^{-1} P^T
    s_theta_fact: object  # dense factor of S_theta = Q - N * S_lam^{-1}
    s_lam_inv: jax.Array  # (n_t, n_t)
    inertia: jax.Array  # (3,) int32: FULL system (all blocks + coupling)
    status: jax.Array  # () int32
    n_pad: int = dataclasses.field(metadata=dict(static=True))


class CondensedLSQSolver(LinearSolver):
    """LinearSolver over :class:`CondensedLSQKKT` (blocks + coupling in one).

    Unlike :class:`~parapint_tpu.linalg.schur.SchurComplementSolver`, which
    composes per-block dense factorizations, this solver IS the whole
    block-bordered solve — the structured path makes the per-block and
    coupling eliminations one pipeline.
    """

    def __init__(
        self,
        tile_size: int = 128,
        zero_tol: float = 0.0,
        factor_dtype=None,
        mesh=None,
        axis_name: str = "blocks",
    ):
        """With ``mesh``, the back solve shards the BLOCK axis over
        ``axis_name`` (the reference's psc parallelism at its default
        605k-variable scale, main.py:84-102): each shard runs the two
        vmapped block-solve passes on its own blocks and the coupling rhs
        reduces with one psum of n_t floats — the factorization itself is
        block-count independent (A is shared across blocks,
        create_model.py:79-91) and replicates like the reference's SC
        factorization."""
        self.tile_size = tile_size
        self.zero_tol = zero_tol
        self.factor_dtype = factor_dtype
        self.mesh = mesh
        self.axis_name = axis_name
        self._dense = DenseLDLSolver(block_size=64, zero_tol=zero_tol)

    def symbolic(self, kkt: CondensedLSQKKT) -> LinearSolverResults:
        p = (kkt.A_bands.shape[1] - 1) // 2
        if 2 * p > self.tile_size:
            raise ValueError(
                f"G half-bandwidth {2*p} exceeds tile size {self.tile_size}"
            )
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, kkt: CondensedLSQKKT) -> CondensedFactor:
        nq, nt, N = kkt.n_q, kkt.n_t, kkt.n_blocks
        dt = kkt.A_bands.dtype
        # G = 2 sum_j B_j^T B_j, half-bandwidth 2p
        g_bands = 2.0 * jnp.sum(jax.vmap(banded_btb)(kkt.A_bands), axis=0)
        g_pad, n_pad = pad_sym_band(g_bands, self.tile_size)
        diag_t, upper_t = sym_band_to_tridiag_tiles(g_pad, self.tile_size)
        g_fact = cr_factor(
            BlockTridiag(diag=diag_t, upper=upper_t),
            block_size=min(64, self.tile_size),
            zero_tol=self.zero_tol,
            factor_dtype=self.factor_dtype,
        )
        # G^{-1} P^T: n_t banded solves (P^T = first-n_t unit columns)
        pt_cols = jnp.zeros((nq + n_pad, nt), dtype=dt)
        pt_cols = pt_cols.at[jnp.arange(nt), jnp.arange(nt)].set(1.0)
        pinv_cols = jax.vmap(
            lambda c: cr_solve(g_fact, c), in_axes=1, out_axes=1
        )(pt_cols)[:nq]
        s_lam = -pinv_cols[:nt]  # -P G^{-1} P^T
        s_lam = 0.5 * (s_lam + s_lam.T)  # symmetrize roundoff
        s_lam_fact = self._dense.numeric(s_lam)
        s_lam_inv = self._dense.solve(s_lam_fact, jnp.eye(nt, dtype=dt))
        # S_theta = Q - sum_i (K_i^{-1})_{lam,lam} = Q - N * S_lam^{-1}
        s_theta = kkt.q_c.astype(dt) - N * s_lam_inv
        s_theta_fact = self._dense.numeric(s_theta)

        # exact inertia (module docstring): per-block Haynsworth sum + theta
        ny = kkt.n_y
        gp, gn, gz = g_fact.inertia  # includes +1 pivots of the n_pad rows
        sp, sn, sz = self._dense.inertia(s_lam_fact)
        tp, tn, tz = self._dense.inertia(s_theta_fact)
        blk = jnp.stack(
            [
                N * (ny + gp - n_pad + sp),
                N * (ny + gn + sn),
                N * (gz + sz),
            ]
        ).astype(jnp.int32)
        inertia = blk + jnp.stack([tp, tn, tz]).astype(jnp.int32)
        status = jnp.maximum(
            g_fact.status,
            jnp.maximum(
                self._dense.status(s_lam_fact), self._dense.status(s_theta_fact)
            ),
        )
        return CondensedFactor(
            g_fact=g_fact,
            pinv_cols=pinv_cols,
            s_lam_fact=s_lam_fact,
            s_theta_fact=s_theta_fact,
            s_lam_inv=s_lam_inv,
            inertia=inertia,
            status=status,
            n_pad=n_pad,
        )

    # -- per-block condensed solve (batched over N via vmap) ----------------

    def _block_solve(self, kkt, fact, b, theta):
        """K_i^{-1} (b_i - A_i^T theta) for one block; b (nk,), theta (n_t,).

        The border A_i = -I on the lam rows, so the theta term only shifts
        b_lam by +theta.
        """
        ny, nq, nt = kkt.n_y, kkt.n_q, kkt.n_t
        nm = kkt.n_mult
        b_y = b[:ny].reshape(nm, nq)
        b_q = b[kkt.off_q : kkt.off_q + nq]
        b_nu = b[kkt.off_nu : kkt.off_nu + ny].reshape(nm, nq)
        b_lam = b[kkt.off_lam :] + theta
        # condensed rhs g = b_q + A^T b_y - 2 A^T b_nu
        aty = jnp.sum(jax.vmap(banded_rmatvec)(kkt.A_bands, b_y), axis=0)
        atnu = jnp.sum(jax.vmap(banded_rmatvec)(kkt.A_bands, b_nu), axis=0)
        g = b_q + aty - 2.0 * atnu
        if fact.n_pad:
            g = jnp.pad(g, (0, fact.n_pad))
        q0 = cr_solve(fact.g_fact, g)[:nq]
        lam = self._dense.solve(fact.s_lam_fact, b_lam - q0[:nt])
        q = q0 - fact.pinv_cols @ lam
        y = jax.vmap(lambda bb: banded_matvec(bb, q))(kkt.A_bands) + b_nu
        nu = b_y - 2.0 * y
        return jnp.concatenate([y.ravel(), nu.ravel(), q, lam])

    def solve(self, fact: CondensedFactor, rhs, kkt: CondensedLSQKKT = None):
        """Full block-bordered back solve.

        rhs: :class:`BlockRhs` with blocks (N, nk) in [y, nu, q, lam] layout
        (the CondensedLSQKKT offsets: off_nu = n_y, off_q = 2 n_y) and
        coupling (n_t,).  ``kkt`` must be the system passed to ``numeric``
        (the factor does not retain the bands).
        """
        if kkt is None:
            raise ValueError("CondensedLSQSolver.solve needs kkt=")
        # NOTE: the theta correction is linear in theta (x = x0 - K^-1
        # e_lam theta), so the second vmapped pass could be replaced by an
        # n_t-column multi-RHS solve precomputed in numeric(); at the
        # current harness scale the back solve is far from dominant, so the
        # simpler two-pass form is kept.
        if self.mesh is not None:
            return self._solve_sharded(fact, rhs, kkt)
        nt = kkt.n_t
        zero_t = jnp.zeros(nt, dtype=rhs.blocks.dtype)
        v = jax.vmap(lambda b: self._block_solve(kkt, fact, b, zero_t))(
            rhs.blocks
        )
        # sc_rhs = b_theta - sum_i A_i v_i = b_theta + sum_i v_i[lam]
        sc_rhs = rhs.coupling + jnp.sum(v[:, kkt.off_lam :], axis=0)
        theta = self._dense.solve(fact.s_theta_fact, sc_rhs)
        x = jax.vmap(lambda b: self._block_solve(kkt, fact, b, theta))(
            rhs.blocks
        )
        return BlockRhs(blocks=x, coupling=theta)

    def _solve_sharded(self, fact, rhs, kkt):
        """Back solve with the block axis sharded over ``self.axis_name``.

        Per-shard work = the two vmapped condensed block solves on the
        shard's own blocks; the only collective is ONE psum of the n_t
        coupling rhs (the reference psc's comm.Allreduce of the SC rhs,
        mpi_explicit_schur_complement.py:387 — its dense-SC-data Allreduce
        has no analogue here because S_theta = Q - N S_lam^{-1} is
        analytic).  The factorization and the theta solve replicate on
        every shard, exactly like the reference's redundant SC
        factorization (:352-360).  Non-divisible block counts are padded
        with zero right-hand sides (a zero rhs contributes zero to the
        coupling reduction; padded outputs are sliced away).
        """
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        ax = self.axis_name
        n_shards = self.mesh.shape[ax]
        N = rhs.blocks.shape[0]
        rem = (-N) % n_shards
        blocks = rhs.blocks
        if rem:
            blocks = jnp.concatenate(
                [blocks, jnp.zeros((rem, blocks.shape[1]), blocks.dtype)]
            )
        nt = kkt.n_t

        def local_solve(fact, kkt, blocks, coupling):
            zero_t = jnp.zeros(nt, dtype=blocks.dtype)
            v = jax.vmap(lambda b: self._block_solve(kkt, fact, b, zero_t))(
                blocks
            )
            sc_local = jnp.sum(v[:, kkt.off_lam :], axis=0)
            sc_rhs = coupling + jax.lax.psum(sc_local, ax)
            theta = self._dense.solve(fact.s_theta_fact, sc_rhs)
            x = jax.vmap(lambda b: self._block_solve(kkt, fact, b, theta))(
                blocks
            )
            return x, theta

        repl = lambda tree: jax.tree_util.tree_map(lambda _: P(), tree)
        x, theta = shard_map(
            local_solve,
            mesh=self.mesh,
            in_specs=(repl(fact), repl(kkt), P(ax), P()),
            out_specs=(P(ax), P()),
            check_vma=False,
        )(fact, kkt, blocks, rhs.coupling)
        return BlockRhs(blocks=x[:N], coupling=theta)

    def inertia(self, fact: CondensedFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: CondensedFactor) -> jax.Array:
        return fact.status
