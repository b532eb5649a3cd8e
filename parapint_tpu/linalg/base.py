"""Linear solver protocol.

The contract mirrors the reference's ``LinearSolverInterface``
(/root/reference/parapint/linalg/base_linear_solver_interface.py:5-56):
symbolic factorization, numeric factorization, back solve, inertia, and a
memory-reallocation hook — but in functional style: ``numeric`` returns a
*factorization pytree* (device arrays, including a status code and the
inertia) instead of mutating solver state, so every method can be traced
inside ``jit``/``shard_map`` and the whole IP step can be fused into one XLA
computation.
"""

import logging
from abc import ABC, abstractmethod
from typing import Any, Tuple

import jax

from parapint_tpu.linalg.results import LinearSolverResults, LinearSolverStatus


class LinearSolver(ABC):
    """Abstract linear solver.

    A *factorization* is an opaque pytree of device arrays produced by
    :meth:`numeric` and consumed by :meth:`solve` / :meth:`inertia` /
    :meth:`status`.  Solver objects themselves hold only static
    configuration and may be reused across systems of the same structure.
    """

    @abstractmethod
    def symbolic(self, kkt: Any) -> LinearSolverResults:
        """Record structural information (shapes / padding).

        Dense device factorizations are structure-oblivious, so this is mostly
        a validation step; it exists for protocol parity with the
        reference's ``do_symbolic_factorization``.
        """

    @abstractmethod
    def numeric(self, kkt: Any) -> Any:
        """Factorize; returns the factorization pytree.  Traceable."""

    @abstractmethod
    def solve(self, fact: Any, rhs: Any) -> Any:
        """Back solve with a previous factorization.  Traceable."""

    @abstractmethod
    def inertia(self, fact: Any) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """(num_pos, num_neg, num_zero) as device scalars.  Traceable."""

    @abstractmethod
    def status(self, fact: Any) -> jax.Array:
        """Device int32 scalar holding a :class:`LinearSolverStatus` value."""

    def solve_with_status(self, fact: Any, rhs: Any) -> Tuple[Any, jax.Array]:
        """Back solve, returning ``(solution, status)``.

        Direct factorizations always succeed once factored, so the default
        returns the factorization status.  Iterative solvers (e.g. the PCG
        Schur solver) override this to report *per-solve* failures —
        non-convergence or negative curvature — as a device int32 status.
        The IP drivers call this (not :meth:`solve`) so a failed iterative
        solve can never be silently treated as a successful step.
        """
        return self.solve(fact, rhs), self.status(fact)

    def increase_memory_allocation(self, factor: float) -> None:
        """Reference protocol hook (base_linear_solver_interface.py:39).

        Dense device factorizations have statically-shaped workspaces, so the
        built-in solvers never report ``not_enough_memory`` and this is a
        no-op; kept so the algorithm's retry loop is identical.
        """

    def results(self, fact: Any) -> LinearSolverResults:
        """Pull status + inertia to host as a LinearSolverResults."""
        status = LinearSolverStatus(int(self.status(fact)))
        pos, neg, zero = self.inertia(fact)
        return LinearSolverResults(
            status=status, inertia=(int(pos), int(neg), int(zero))
        )

    def getLogger(self) -> logging.Logger:
        """Logger hook (reference base_linear_solver_interface.py:16-23)."""
        return logging.getLogger("algorithms." + self.__class__.__name__)
