"""Schur-complement performance harness.

JAX transcription of the reference's synthetic structured-least-squares
benchmark (/root/reference/parapint/examples/performance/schur_complement/):
each block b solves  min ||y - y_hat_b||^2  s.t.  y = A q,  P q = theta
with the first n_theta entries of q shared across blocks through coupling
variables theta.  The per-block KKT (create_model.py:23-47), in the
quasi-definite [y, nu, q, lam] ordering (see SyntheticModel.__post_init__):

    [2I   I    0    0  ] [y  ]   [2 y_hat]
    [I    0   -A    0  ] [nu ] = [0      ]
    [0   -A^T  0    P^T] [q  ]   [0      ]
    [0    0    P    0  ] [lam]   [0      ]

with border rows -P_d^T linking lam to the global theta block.  Correctness
is recovery of the planted q/theta (create_model.py:60-64).

Methods (main.py:84-102): fs = full-space dense factorization,
ssc = serial (batched) Schur complement, psc = sharded Schur complement,
plus csc = condensed structured solver
(:mod:`parapint_tpu.linalg.condensed`), which exploits the banded
least-squares block structure and runs the reference's DEFAULT sizes
(n_q_per_block=5000, n_y_multiplier=120 -> 605k variables per block,
main.py:63-73) that the dense methods cannot touch.
"""

import dataclasses
import time

import numpy as np
import jax
import jax.numpy as jnp

import parapint_tpu as pt
from parapint_tpu.linalg.schur import BlockRhs, LocalBlockKKT


def _banded(n, nnz_per_row, rng):
    """Random banded matrix (utils.py:24-31): sum of +-k diagonals, k <
    (nnz_per_row+1)/2, with N(0, 5) data."""
    assert nnz_per_row % 2 == 1
    m = np.eye(n)
    for k in range(1, (nnz_per_row - 1) // 2 + 1):
        m += np.eye(n, k=k) + np.eye(n, k=-k)
    m *= rng.normal(loc=0.0, scale=5.0, size=(n, n)) * (m != 0)
    return m


@dataclasses.dataclass
class SyntheticModel:
    """The synthetic block-structured KKT system."""

    n_blocks: int
    n_q_per_block: int = 256
    n_y_multiplier: int = 2
    n_theta: int = 10
    A_nnz_per_row: int = 3

    def __post_init__(self):
        rng = np.random.default_rng(0)
        nq = self.n_q_per_block
        ny = nq * self.n_y_multiplier
        nt = self.n_theta
        p = (self.A_nnz_per_row - 1) // 2
        self.half_bw = p
        self.n_y_per_block = ny
        # band-first construction (utils.py:24-31 structure): the condensed
        # method never materializes A densely, which is what makes the
        # reference's default scale (600k-variable blocks) runnable
        self.A_bands = np.zeros((self.n_y_multiplier, 2 * p + 1, nq))
        ids = np.arange(nq)
        for j in range(self.n_y_multiplier):
            for d in range(-p, p + 1):
                v = rng.normal(loc=0.0, scale=5.0, size=nq)
                self.A_bands[j, d + p] = np.where(
                    (ids + d >= 0) & (ids + d < nq), v, 0.0
                )
        self._A_dense = None
        self.theta = rng.normal(loc=5.0, scale=2.0, size=nt)
        self.q_true = np.zeros((self.n_blocks, nq))
        self.y_hat = np.zeros((self.n_blocks, ny))
        for b in range(self.n_blocks):
            q = rng.normal(loc=5.0, scale=2.0, size=nq)
            q[:nt] = self.theta
            y = self._band_matvec(q)
            y += rng.normal(0.0, 0.01 * np.abs(y).max(), size=ny)
            self.q_true[b] = q
            self.y_hat[b] = y
        # Per-block layout [y, nu, q, lam] — the quasi-definite elimination
        # order for the UNPIVOTED batched LDL^T: pivots arrive as
        # 2 (y), -1/2 (nu), 2A^TA SPD (q), -P G^{-1} P^T (lam), all nonzero.
        # The reference's [y, q, nu, lam] ordering (create_model.py:28-47)
        # is fine for pivoted MA27 but gives an exactly-zero pivot at the
        # first q column without pivoting.
        self.nk = ny + ny + nq + nt
        self.off_nu = ny
        self.off_q = 2 * ny
        self.off_lam = 2 * ny + nq

    def _band_matvec(self, q: np.ndarray) -> np.ndarray:
        """A @ q from the band store (numpy, setup-time only)."""
        nm, nb, nq = self.A_bands.shape
        p = (nb - 1) // 2
        out = np.zeros((nm, nq))
        for d in range(-p, p + 1):
            lo, hi = max(0, -d), min(nq, nq - d)
            out[:, lo:hi] += (
                self.A_bands[:, d + p, lo:hi] * q[lo + d : hi + d]
            )
        return out.reshape(-1)

    @property
    def A(self) -> np.ndarray:
        """Dense A (built lazily; only the dense methods need it)."""
        if self._A_dense is None:
            nm, nb, nq = self.A_bands.shape
            p = (nb - 1) // 2
            blocks = []
            for j in range(nm):
                m = np.zeros((nq, nq))
                for d in range(-p, p + 1):
                    lo, hi = max(0, -d), min(nq, nq - d)
                    m[np.arange(lo, hi), np.arange(lo, hi) + d] = self.A_bands[
                        j, d + p, lo:hi
                    ]
                blocks.append(m)
            self._A_dense = np.concatenate(blocks, axis=0)
        return self._A_dense

    def build_block_diag(self) -> np.ndarray:
        ny, nq, nt, nk = self.n_y_per_block, self.n_q_per_block, self.n_theta, self.nk
        K = np.zeros((nk, nk))
        K[:ny, :ny] = 2.0 * np.eye(ny)
        K[:ny, self.off_nu : self.off_nu + ny] = np.eye(ny)
        K[self.off_nu : self.off_nu + ny, :ny] = np.eye(ny)
        K[self.off_q : self.off_q + nq, self.off_nu : self.off_nu + ny] = -self.A.T
        K[self.off_nu : self.off_nu + ny, self.off_q : self.off_q + nq] = -self.A
        P = np.zeros((nt, nq))
        P[:, :nt] = np.eye(nt)
        K[self.off_q : self.off_q + nq, self.off_lam :] = P.T
        K[self.off_lam :, self.off_q : self.off_q + nq] = P
        return np.broadcast_to(K, (self.n_blocks, nk, nk)).copy()

    def build_kkt(self) -> LocalBlockKKT:
        nt = self.n_theta
        border_loc = np.zeros((self.n_blocks, nt, self.nk))
        for j in range(nt):
            border_loc[:, j, self.off_lam + j] = -1.0
        row_idx = np.broadcast_to(
            np.arange(nt, dtype=np.int32), (self.n_blocks, nt)
        ).copy()
        return LocalBlockKKT.make(
            diag=jnp.asarray(self.build_block_diag()),
            border_loc=jnp.asarray(border_loc),
            row_idx=row_idx,
            q=jnp.zeros((nt, nt)),
        )

    def build_rhs(self) -> BlockRhs:
        rhs = np.zeros((self.n_blocks, self.nk))
        rhs[:, : self.n_y_per_block] = 2.0 * self.y_hat
        return BlockRhs(
            blocks=jnp.asarray(rhs), coupling=jnp.zeros(self.n_theta)
        )

    def build_dense(self):
        """Monolithic dense KKT for the full-space method."""
        N, nk, nt = self.n_blocks, self.nk, self.n_theta
        dim = N * nk + nt
        M = np.zeros((dim, dim))
        diag = self.build_block_diag()
        for b in range(N):
            M[b * nk : (b + 1) * nk, b * nk : (b + 1) * nk] = diag[b]
            for j in range(nt):
                M[N * nk + j, b * nk + self.off_lam + j] = -1.0
                M[b * nk + self.off_lam + j, N * nk + j] = -1.0
        rhs = np.zeros(dim)
        rhs[: N * nk] = np.asarray(self.build_rhs().blocks).reshape(-1)
        return jnp.asarray(M), jnp.asarray(rhs)

    def check_result(self, sol_blocks) -> float:
        """max |q_estimate - q_true| over all blocks (create_model.py:60-64)."""
        q_est = np.asarray(sol_blocks)[:, self.off_q : self.off_q + self.n_q_per_block]
        return float(np.abs(q_est - self.q_true).max())


@dataclasses.dataclass
class Result:
    max_err: float = 0.0
    symbolic_time: float = 0.0
    numeric_time: float = 0.0
    back_solve_time: float = 0.0
    total_time: float = 0.0
    status: int = 0  # LinearSolverStatus of the numeric factorization


def run(
    method: str = "ssc",
    n_blocks: int = 4,
    n_q_per_block: int = 256,
    n_y_multiplier: int = 2,
    n_theta: int = 10,
    A_nnz_per_row: int = 3,
    mesh=None,
    block_size: int = 128,
    verbose: bool = True,
    warm: bool = False,
) -> Result:
    """Run one method/size configuration and report phase timings.

    ``warm=True`` runs numeric+solve twice and times the SECOND pass, so
    the one-time XLA compile is excluded — the comparable quantity to the
    reference's per-call MA27 timings (its symbolic analysis is amortized
    the same way across IP iterations).
    """
    m = SyntheticModel(
        n_blocks=n_blocks,
        n_q_per_block=n_q_per_block,
        n_y_multiplier=n_y_multiplier,
        n_theta=n_theta,
        A_nnz_per_row=A_nnz_per_row,
    )
    res = Result()

    if method == "fs":
        solver = pt.DenseLDLSolver(block_size=block_size)
        kkt, rhs = m.build_dense()
        t0 = time.time()
        solver.symbolic(kkt)
        t1 = time.time()
        fact = solver.numeric(kkt)
        jax.block_until_ready(fact)
        t2 = time.time()
        x = solver.solve(fact, rhs)
        jax.block_until_ready(x)
        t3 = time.time()
        if warm:
            # re-time ONLY numeric+solve; symbolic_time keeps the cold
            # t1 - t0 (re-basing t1 here would mislabel the compile + cold
            # pass as symbolic analysis)
            res.symbolic_time = t1 - t0
            t1 = time.time()
            fact = solver.numeric(kkt)
            jax.block_until_ready(fact)
            t2 = time.time()
            x = solver.solve(fact, rhs)
            jax.block_until_ready(x)
            t3 = time.time()
            t0 = t1
        sol_blocks = np.asarray(x)[: n_blocks * m.nk].reshape(n_blocks, m.nk)
    elif method == "csc":
        # condensed structured method: exploits the banded least-squares
        # block structure (y/nu eliminated analytically, banded G = 2A^T A
        # factored by cyclic reduction) — runs the reference's DEFAULT sizes
        # (n_q_per_block=5000, n_y_multiplier=120, main.py:63-73), which the
        # dense methods cannot
        from parapint_tpu.linalg import CondensedLSQKKT, CondensedLSQSolver

        # mesh: shard the block axis of the back solve (the reference psc's
        # parallel axis at its default scale; the factorization is
        # block-count independent and replicates)
        solver = CondensedLSQSolver(tile_size=block_size, mesh=mesh)
        kkt = CondensedLSQKKT(
            A_bands=jnp.asarray(m.A_bands),
            q_c=jnp.zeros((n_theta, n_theta)),
            n_t=n_theta,
            n_blocks=n_blocks,
        )
        rhs = m.build_rhs()
        numeric = jax.jit(solver.numeric)
        solve = jax.jit(lambda f, r: solver.solve(f, r, kkt=kkt))
        t0 = time.time()
        solver.symbolic(kkt)
        t1 = time.time()
        fact = numeric(kkt)
        jax.block_until_ready(fact)
        t2 = time.time()
        x = solve(fact, rhs)
        jax.block_until_ready(x)
        t3 = time.time()
        if warm:
            # re-time ONLY numeric+solve (see the warm note above)
            res.symbolic_time = t1 - t0
            t1 = time.time()
            fact = numeric(kkt)
            jax.block_until_ready(fact)
            t2 = time.time()
            x = solve(fact, rhs)
            jax.block_until_ready(x)
            t3 = time.time()
            t0 = t1
        sol_blocks = x.blocks
    else:
        if method == "ssc":
            solver = pt.SchurComplementSolver(block_size=block_size)
        elif method == "psc":
            if mesh is None:
                from jax.sharding import Mesh

                # largest device count that divides the block count
                ndev = len(jax.devices())
                while n_blocks % ndev != 0:
                    ndev -= 1
                mesh = Mesh(np.array(jax.devices()[:ndev]), ("blocks",))
            solver = pt.ShardedSchurComplementSolver(mesh, "blocks", block_size=block_size)
        else:
            raise ValueError(f"unknown method {method!r}")
        kkt = m.build_kkt()
        rhs = m.build_rhs()
        t0 = time.time()
        solver.symbolic(kkt)
        t1 = time.time()
        fact = solver.numeric(kkt)
        jax.block_until_ready(fact)
        t2 = time.time()
        x = solver.solve(fact, rhs)
        jax.block_until_ready(x)
        t3 = time.time()
        if warm:
            # re-time ONLY numeric+solve; symbolic_time keeps the cold
            # t1 - t0 (re-basing t1 here would mislabel the compile + cold
            # pass as symbolic analysis)
            res.symbolic_time = t1 - t0
            t1 = time.time()
            fact = solver.numeric(kkt)
            jax.block_until_ready(fact)
            t2 = time.time()
            x = solver.solve(fact, rhs)
            jax.block_until_ready(x)
            t3 = time.time()
            t0 = t1
        sol_blocks = x.blocks

    res.status = int(solver.status(fact))
    res.max_err = m.check_result(sol_blocks)
    if not warm:
        res.symbolic_time = t1 - t0
    res.numeric_time = t2 - t1
    res.back_solve_time = t3 - t2
    # warm: numeric + solve only (symbolic is a pure shape check)
    res.total_time = res.symbolic_time + (t2 - t1) + (t3 - t2)

    if verbose:
        method_map = {
            "fs": "Full Space",
            "ssc": "Serial Schur-Complement",
            "psc": "Parallel Schur-Complement",
            "csc": "Condensed Structured SC",
        }
        print(
            f"{'method':<30}{'# devices':<12}{'# blocks':<12}{'n_q_per_block':<15}"
            f"{'n_y_multiplier':<15}{'n_theta':<10}{'A NNZ per row':<15}"
            f"{'Est Err':<12}{'Symb Fact (s)':<15}{'Num Fact (s)':<15}"
            f"{'Back Solve (s)':<15}{'Total Time (s)':<15}"
        )
        print(
            f"{method_map[method]:<30}{len(jax.devices()):<12}{n_blocks:<12}"
            f"{n_q_per_block:<15}{n_y_multiplier:<15}{n_theta:<10}"
            f"{A_nnz_per_row:<15}{res.max_err:<12.3f}{res.symbolic_time:<15.3f}"
            f"{res.numeric_time:<15.3f}{res.back_solve_time:<15.3f}"
            f"{res.total_time:<15.3f}"
        )
    return res


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--method", type=str, required=True, choices={"fs", "ssc", "psc", "csc"}
    )
    parser.add_argument("--n_blocks", type=int, required=True)
    parser.add_argument("--n_q_per_block", type=int, default=256)
    parser.add_argument("--n_y_multiplier", type=int, default=2)
    args = parser.parse_args()
    run(
        method=args.method,
        n_blocks=args.n_blocks,
        n_q_per_block=args.n_q_per_block,
        n_y_multiplier=args.n_y_multiplier,
    )


if __name__ == "__main__":
    main()
