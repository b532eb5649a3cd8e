"""Host (C++) Bunch-Kaufman solver behind the LinearSolver protocol.

The robust *pivoted* symmetric-indefinite factorization — the role HSL MA27
plays in the reference (/root/reference/parapint/linalg/ma27_interface.py):
handles saddle-point KKT matrices with zero diagonals that the unpivoted device
kernel cannot factor without regularization, and reads the inertia off the
1x1/2x2 pivot blocks.

Host-side and NOT jit-traceable: use with the Python-loop
:func:`parapint_tpu.algorithms.ip_solve` (CPU execution), as the correctness
oracle for the device kernels, or as the ``schur_complement_solver`` of a
serial Schur solver running on CPU.  The batched entry points factor
independent blocks in parallel with OpenMP.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from parapint_tpu import native
from parapint_tpu.linalg.base import LinearSolver
from parapint_tpu.linalg.results import LinearSolverResults, LinearSolverStatus


@dataclasses.dataclass
class HostBKFactor:
    factors: np.ndarray  # (nb, n, n)
    ipiv: np.ndarray  # (nb, n) int32
    inertia_: tuple  # (pos, neg, zero) ints summed over batch
    status_: int
    batched: bool  # False: single matrix squeezed


class HostBKSolver(LinearSolver):
    """Pivoted LDL^T on host; accepts (n, n) or batched (nb, n, n) input."""

    def __init__(self):
        if not native.available():
            raise RuntimeError(
                "native bk_ldl library unavailable (g++ build failed?)"
            )

    def symbolic(self, kkt) -> LinearSolverResults:
        a = np.asarray(kkt)
        if a.shape[-1] != a.shape[-2]:
            raise ValueError(f"matrix is not square: {a.shape}")
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, kkt) -> HostBKFactor:
        a = np.asarray(kkt, dtype=np.float64)
        batched = a.ndim == 3
        if not batched:
            a = a[None]
        factors, ipiv, infos = native.bk_factor(a)
        pos, neg, zero = native.bk_inertia(factors, ipiv)
        ok = bool((infos == 0).all())
        return HostBKFactor(
            factors=factors,
            ipiv=ipiv,
            inertia_=(int(pos.sum()), int(neg.sum()), int(zero.sum())),
            status_=int(
                LinearSolverStatus.successful if ok else LinearSolverStatus.singular
            ),
            batched=batched,
        )

    def solve(self, fact: HostBKFactor, rhs):
        b = np.asarray(rhs, dtype=np.float64)
        if fact.batched:
            # rhs (nb, n) -> one RHS per block
            x = native.bk_solve(fact.factors, fact.ipiv, b[:, None, :])
            return jnp.asarray(x[:, 0, :])
        if b.ndim == 1:
            x = native.bk_solve(fact.factors, fact.ipiv, b[None, None, :])
            return jnp.asarray(x[0, 0])
        # (n, k) multi-RHS
        x = native.bk_solve(fact.factors, fact.ipiv, b.T[None])
        return jnp.asarray(x[0].T)

    def inertia(self, fact: HostBKFactor):
        p, n, z = fact.inertia_
        return jnp.int32(p), jnp.int32(n), jnp.int32(z)

    def status(self, fact: HostBKFactor):
        return jnp.int32(fact.status_)
