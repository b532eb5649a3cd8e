"""Matrix-free Schur-complement solver: PCG on the coupling system.

Beyond-reference capability (the "distributed PCG with block preconditioning"
coupling option): for large coupling dimensions nc, forming and factorizing
the dense nc x nc Schur complement costs O(nc^2) memory + O(nc^3) flops,
replicated on every shard.  This solver never forms S; it runs preconditioned
conjugate gradients on

    S y = r,   S = Q - sum_i A_i K_i^{-1} A_i^T

whose matvec is one batched per-block K^{-1} application (two thin matmuls)
plus a psum — the same cross-device traffic pattern as the reference's SC rhs
Allreduce (mpi_explicit_schur_complement.py:387), once per CG iteration.

S is symmetric positive definite whenever the block factorizations carry
their expected inertia (the coupling variables are primal; Haynsworth), so
CG is the right Krylov method; encountering nonpositive curvature flags the
factorization as singular.  Preconditioner: exact Jacobi (diag S), computed
from the same per-block multi-column solve that dense SC formation uses.

Note on inertia: this solver verifies the block inertia exactly but does not
compute the SC's (that is the point of not forming it); it reports the SC as
(nc, 0, 0), the value it must have at a usable iterate.  A wrong SC inertia
surfaces as CG negative curvature during the solve, which sets the error
status.  Use the explicit solvers when exact global inertia matters more
than scaling.
"""

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from parapint_tpu.linalg.base import LinearSolver
from parapint_tpu.linalg.dense import DenseLDLSolver
from parapint_tpu.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu.linalg.schur import (
    BlockRhs,
    LocalBlockKKT,
    _border_apply_local,
    _border_T_apply_local,
    _factor_blocks_winv,
    _winv_apply_batched,
    _winv_multi,
    _scatter_sc,
    pad_block_count,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PCGSchurFactor:
    block_W: jax.Array
    block_d: jax.Array
    block_s: jax.Array
    border_loc: jax.Array
    row_idx: jax.Array
    q: jax.Array
    precond: jax.Array  # (nc,) 1/diag(S)
    inertia: jax.Array
    status: jax.Array
    nk: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))


class PCGSchurComplementSolver(LinearSolver):
    """Schur-complement solver with CG on the (never-formed) coupling system.

    Works on :class:`LocalBlockKKT` systems.  Serial by default; pass a mesh
    to shard the block axis (every CG iteration then does one psum over the
    mesh axis).
    """

    def __init__(
        self,
        mesh: Optional[Mesh] = None,
        axis_name: str = "blocks",
        block_size: int = 128,
        zero_tol: float = 0.0,
        factor_dtype=None,
        cg_tol: float = 1e-12,
        cg_maxiter: int = 200,
        refine_steps: Optional[int] = None,
    ):
        self.mesh = mesh
        self.axis_name = axis_name
        self.block_size = block_size
        self.zero_tol = zero_tol
        self.factor_dtype = factor_dtype
        self.cg_tol = cg_tol
        self.cg_maxiter = cg_maxiter
        # CG already iterates to tolerance on the coupling system; block
        # refinement is folded into the CG rhs/solution accuracy
        self.refine_steps = 0 if refine_steps is None else refine_steps

    def symbolic(self, kkt: LocalBlockKKT) -> LinearSolverResults:
        if not isinstance(kkt, LocalBlockKKT):
            raise TypeError("PCGSchurComplementSolver requires a LocalBlockKKT")
        return LinearSolverResults(status=LinearSolverStatus.successful)

    # -- numeric -----------------------------------------------------------

    def numeric(self, kkt: LocalBlockKKT) -> PCGSchurFactor:
        if self.mesh is not None:
            # non-divisible block counts pad with masked identity blocks
            kkt = pad_block_count(kkt, self.mesh.shape[self.axis_name])
        nc = kkt.q.shape[-1]

        def _numeric(diag, border_loc, row_idx, q, mask):
            W, d, s, inertia, status = _factor_blocks_winv(
                diag, mask, self.block_size, self.zero_tol, self.factor_dtype
            )
            # exact diag(S) for the Jacobi preconditioner: the diagonal of
            # the local S contributions, scattered (no L x L product, no
            # dense S)
            S_loc = _winv_multi(W, d, s, jnp.swapaxes(border_loc, 1, 2))
            diag_contrib = jnp.einsum("bll->bl", S_loc)
            dS = jnp.zeros(nc + 1, dtype=diag_contrib.dtype)
            dS = dS.at[row_idx].add(-diag_contrib)
            dS = dS[:nc]
            if self.mesh is not None:
                dS = jax.lax.psum(dS, self.axis_name)
                inertia = jax.lax.psum(inertia, self.axis_name)
                status = jax.lax.pmax(status, self.axis_name)
            dS = dS + jnp.diagonal(q).astype(dS.dtype)
            precond = jnp.where(jnp.abs(dS) > 0, 1.0 / dS, 1.0)
            # SC assumed SPD given correct block inertia (see module doc)
            inertia = inertia + jnp.stack(
                [jnp.int32(nc), jnp.int32(0), jnp.int32(0)]
            )
            return W, d, s, precond, inertia, status

        if self.mesh is None:
            W, d, s, precond, inertia, status = _numeric(
                kkt.diag, kkt.border_loc, kkt.row_idx, kkt.q, kkt.mask
            )
        else:
            ax = self.axis_name
            W, d, s, precond, inertia, status = shard_map(
                _numeric,
                mesh=self.mesh,
                in_specs=(P(ax), P(ax), P(ax), P(), P(ax)),
                out_specs=(P(ax), P(ax), P(ax), P(), P(), P()),
                check_vma=False,
            )(kkt.diag, kkt.border_loc, kkt.row_idx, kkt.q, kkt.mask)
        return PCGSchurFactor(
            block_W=W,
            block_d=d,
            block_s=s,
            border_loc=kkt.border_loc,
            row_idx=kkt.row_idx,
            q=kkt.q,
            precond=precond,
            inertia=inertia,
            status=status,
            nk=kkt.diag.shape[-1],
            nc=nc,
        )

    # -- solve -------------------------------------------------------------

    def _sc_matvec(self, fact, y, psum_axis=None):
        """S y = Q y - sum_i A_i K_i^{-1} A_i^T y."""
        ay = _border_T_apply_local(fact.border_loc, fact.row_idx, y)  # (N, nk)
        v = _winv_apply_batched(fact.block_W, fact.block_d, fact.block_s, ay)
        contrib = _border_apply_local(fact.border_loc, fact.row_idx, v, fact.nc)
        if psum_axis is not None:
            contrib = jax.lax.psum(contrib, psum_axis)
        return jnp.matmul(fact.q, y, preferred_element_type=y.dtype) - contrib

    def _cg(self, fact, rhs, psum_axis=None):
        """Jacobi-PCG; returns (y, converged, neg_curvature)."""
        M = fact.precond.astype(rhs.dtype)

        def body(carry):
            y, r, p, rz, it, neg = carry
            Sp = self._sc_matvec(fact, p, psum_axis)
            pSp = jnp.dot(p, Sp)
            neg = jnp.logical_or(neg, pSp <= 0.0)
            alpha = rz / jnp.where(pSp != 0.0, pSp, 1.0)
            y = y + alpha * p
            r = r - alpha * Sp
            z = M * r
            rz_new = jnp.dot(r, z)
            beta = rz_new / jnp.where(rz != 0.0, rz, 1.0)
            p = z + beta * p
            return y, r, p, rz_new, it + 1, neg

        def cond(carry):
            y, r, p, rz, it, neg = carry
            return jnp.logical_and(
                jnp.logical_and(
                    jnp.linalg.norm(r) > self.cg_tol * (1.0 + jnp.linalg.norm(rhs)),
                    it < self.cg_maxiter,
                ),
                jnp.logical_not(neg),
            )

        y0 = jnp.zeros_like(rhs)
        r0 = rhs
        z0 = M * r0
        carry = lax.while_loop(
            cond, body, (y0, r0, z0, jnp.dot(r0, z0), jnp.int32(0), jnp.asarray(False))
        )
        y, r, p, rz, it, neg = carry
        converged = jnp.linalg.norm(r) <= self.cg_tol * (1.0 + jnp.linalg.norm(rhs))
        return y, converged, neg

    def solve_with_status(self, fact: PCGSchurFactor, rhs: BlockRhs):
        """Solve, returning the per-solve CG status as well.

        Negative curvature during CG means S is not positive definite — the
        factorization's assumed SC inertia (nc, 0, 0) was wrong — and maps
        to ``singular`` so the IP loop's inertia correction engages;
        hitting ``cg_maxiter`` without converging maps to ``error``.
        """

        def _solve(fact, blocks, coupling, psum_axis=None):
            v = _winv_apply_batched(
                fact.block_W, fact.block_d, fact.block_s, blocks
            ).astype(blocks.dtype)
            contrib = _border_apply_local(
                fact.border_loc, fact.row_idx, v, fact.nc
            )
            if psum_axis is not None:
                contrib = jax.lax.psum(contrib, psum_axis)
            sc_rhs = coupling - contrib
            y, converged, neg = self._cg(fact, sc_rhs, psum_axis)
            rhs2 = blocks - _border_T_apply_local(fact.border_loc, fact.row_idx, y)
            x = _winv_apply_batched(
                fact.block_W, fact.block_d, fact.block_s, rhs2
            ).astype(blocks.dtype)
            solve_status = jnp.where(
                neg,
                jnp.int32(LinearSolverStatus.singular),
                jnp.where(
                    converged,
                    jnp.int32(LinearSolverStatus.successful),
                    jnp.int32(LinearSolverStatus.error),
                ),
            )
            return x, y, solve_status

        # the factorization may carry auto-padded blocks (see numeric)
        nb = fact.block_W.shape[0]
        n_rhs = rhs.blocks.shape[0]
        blocks_in = rhs.blocks
        if n_rhs != nb:
            blocks_in = jnp.pad(rhs.blocks, ((0, nb - n_rhs), (0, 0)))
        rhs = BlockRhs(blocks=blocks_in, coupling=rhs.coupling)

        if self.mesh is None:
            x, y, solve_status = _solve(fact, rhs.blocks, rhs.coupling)
        else:
            ax = self.axis_name
            fact_specs = PCGSchurFactor(
                block_W=P(ax),
                block_d=P(ax),
                block_s=P(ax),
                border_loc=P(ax),
                row_idx=P(ax),
                q=P(),
                precond=P(),
                inertia=P(),
                status=P(),
                nk=fact.nk,
                nc=fact.nc,
            )
            x, y, solve_status = shard_map(
                lambda f, b, c: _solve(f, b, c, psum_axis=ax),
                mesh=self.mesh,
                in_specs=(fact_specs, P(ax), P()),
                out_specs=(P(ax), P(), P()),
                check_vma=False,
            )(fact, rhs.blocks, rhs.coupling)
        status = jnp.maximum(fact.status, solve_status)
        return BlockRhs(blocks=x[:n_rhs], coupling=y), status

    def solve(self, fact: PCGSchurFactor, rhs: BlockRhs) -> BlockRhs:
        """Back solve.  A failed CG (non-convergence / negative curvature)
        NaN-poisons the solution so it can never be consumed as a valid
        step; prefer :meth:`solve_with_status` for an inspectable status."""
        sol, status = self.solve_with_status(fact, rhs)
        ok = status <= jnp.int32(LinearSolverStatus.warning)
        poison = jnp.where(ok, 0.0, jnp.nan)
        return BlockRhs(
            blocks=sol.blocks + poison.astype(sol.blocks.dtype),
            coupling=sol.coupling + poison.astype(sol.coupling.dtype),
        )

    def inertia(self, fact: PCGSchurFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: PCGSchurFactor) -> jax.Array:
        return fact.status
