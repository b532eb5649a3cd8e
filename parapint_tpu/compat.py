"""Reference-name compatibility layer.

``import parapint_tpu.compat as parapint`` gives user code the reference's
public names (/root/reference/parapint/*/__init__.py) mapped onto this
framework's JAX classes, for near-drop-in porting:

    import parapint_tpu.compat as parapint
    options = parapint.algorithms.IPOptions()
    options.linalg.solver = parapint.linalg.ScipyInterface(compute_inertia=True)
    status = parapint.algorithms.ip_solve(interface, options)

Model construction necessarily differs (pure JAX functions instead of Pyomo
models — see DynamicModelSpec / StochasticModelSpec / NLPModel), but solver
and algorithm call sites carry over.
"""

import types
import warnings

import jax as _jax

import parapint_tpu as _pt
from parapint_tpu.linalg import (
    DenseLDLSolver as _DenseLDLSolver,
    DenseLUSolver as _DenseLUSolver,
    SchurComplementSolver as _SchurComplementSolver,
    ShardedSchurComplementSolver as _ShardedSchurComplementSolver,
)


class ScipyInterface(_DenseLUSolver):
    """Reference ``parapint.linalg.ScipyInterface`` (scipy_interface.py:11):
    LU with optional dense-eigenvalue inertia."""

    def __init__(self, compute_inertia: bool = False):
        super().__init__(compute_inertia=compute_inertia)


def _warn_unmapped(name, kind, keys):
    if keys:
        warnings.warn(
            f"{name}: {kind} options {sorted(keys)} have no equivalent on "
            f"the dense device factorization and are ignored; see "
            f"DenseLDLSolver for the available knobs",
            stacklevel=3,
        )


class InteriorPointMA27Interface(_DenseLDLSolver):
    """Reference ``parapint.linalg.InteriorPointMA27Interface``
    (ma27_interface.py:9): symmetric indefinite factorization + inertia.

    Option mapping (ma27_interface.py:36-47, 205-256):

    - ``cntl_options[1]`` (pivot threshold u): the unpivoted equilibrated
      device factorization has no pivot order to steer; its stability comes
      from Ruiz equilibration + (adaptive) iterative refinement.  The value
      is recorded (``get_cntl``) and any u > 0 keeps refinement enabled.
    - ``icntl_options`` are MA27 workspace/printing controls: recorded,
      behaviorally no-ops (statically-shaped workspaces never reallocate).
    - ``iw_factor``/``a_factor`` (memory growth factors): accepted no-ops,
      mirroring :meth:`increase_memory_allocation`.
    """

    def __init__(
        self,
        cntl_options=None,
        icntl_options=None,
        iw_factor=None,
        a_factor=None,
        **kwargs,
    ):
        self._cntl = dict(cntl_options or {})
        self._icntl = dict(icntl_options or {})
        if self._cntl.get(1, 0.0) and "refine_steps" not in kwargs:
            kwargs["refine_steps"] = 1  # keep the stability pass
        _warn_unmapped(
            "InteriorPointMA27Interface", "cntl", set(self._cntl) - {1}
        )
        super().__init__(**kwargs)

    def set_cntl(self, key, value):
        self._cntl[key] = value

    def get_cntl(self, key):
        return self._cntl[key]

    def set_icntl(self, key, value):
        self._icntl[key] = value

    def get_icntl(self, key):
        return self._icntl[key]


class MumpsInterface(_DenseLDLSolver):
    """Reference ``parapint.linalg.MumpsInterface`` (mumps_interface.py:11).

    Option mapping (mumps_interface.py:17-60):

    - ``icntl_options[10]`` (iterative refinement steps) -> ``refine_steps``.
    - ``icntl_options[11]`` (error analysis level) -> per-solve diagnostics
      logging, mirroring the reference's log_header/log_info rows
      (mumps_interface.py:179-228): Status, n_null, n_neg, ||A||, ||x||,
      Max resid — with the residual computed directly (no rinfog).
    - ``icntl_options[13]``/``[24]`` validated exactly like the reference's
      ``set_icntl`` (must be positive / must be 0).
    - ``icntl_options[14]``/``[23]`` (memory controls) -> recorded no-ops
      (statically-shaped workspaces).
    - ``cntl_options[3]`` (null-pivot detection threshold) -> ``zero_tol``.
    - ``cntl_options[1]`` (relative pivoting threshold): recorded; stability
      comes from Ruiz equilibration + refinement (any u > 0 keeps a
      refinement pass enabled).
    """

    def __init__(
        self, par=1, comm=None, cntl_options=None, icntl_options=None, **kwargs
    ):
        self._cntl = dict(cntl_options or {})
        self._icntl = dict(icntl_options or {})
        for key, value in self._icntl.items():
            self.set_icntl(key, value, _init=True)
        if 10 in self._icntl and "refine_steps" not in kwargs:
            kwargs["refine_steps"] = max(0, int(self._icntl[10]))
        if 3 in self._cntl and "zero_tol" not in kwargs:
            kwargs["zero_tol"] = float(self._cntl[3])
        if self._cntl.get(1, 0.0) and "refine_steps" not in kwargs:
            kwargs["refine_steps"] = 1
        self.error_level = int(self._icntl.get(11, 0))
        self.log_error = bool(self.error_level)
        _warn_unmapped("MumpsInterface", "cntl", set(self._cntl) - {1, 2, 3})
        _warn_unmapped(
            "MumpsInterface",
            "icntl",
            set(self._icntl) - {10, 11, 13, 14, 23, 24},
        )
        super().__init__(**kwargs)
        self.logger = self.getLogger()
        self._last_kkt = None
        if self.log_error:
            self.log_header()

    # option accessors (reference mumps_interface.py:147-168)
    def set_icntl(self, key, value, _init=False):
        if key == 13 and value <= 0:
            raise ValueError("ICNTL(13) must be positive for the MumpsInterface.")
        if key == 24 and value != 0:
            raise ValueError("ICNTL(24) must be 0 for the MumpsInterface.")
        self._icntl[key] = value

    def get_icntl(self, key):
        return self._icntl[key]

    def set_cntl(self, key, value):
        self._cntl[key] = value

    def get_cntl(self, key):
        return self._cntl[key]

    # per-solve diagnostics (reference mumps_interface.py:179-228)
    def log_header(self, include_error=True):
        fields = ["Status", "n_null", "n_neg"]
        if include_error:
            fields += ["||A||", "||x||", "Max resid", "Rel resid"]
        fmt = "{0:<10}{1:<10}{2:<10}" + "".join(
            "{" + str(i) + ":<15}" for i in range(3, len(fields))
        )
        self.logger.info(fmt.format(*fields))

    def numeric(self, kkt):
        fact = super().numeric(kkt)
        if self.log_error:
            # a traced numeric() leaves no concrete matrix: clear the cache
            # so a later untraced solve() cannot log residuals of a STALE
            # matrix from an earlier factorization
            self._last_kkt = (
                None if isinstance(kkt, _jax.core.Tracer) else kkt
            )
        return fact

    def solve(self, fact, rhs):
        x = super().solve(fact, rhs)
        if self.log_error and not isinstance(x, _jax.core.Tracer):
            self.log_info(fact, rhs, x)
        return x

    def log_info(self, fact, rhs, x):
        import numpy as _np

        status = int(fact.status)
        n_null = int(fact.inertia[2])
        n_neg = int(fact.inertia[1])
        fields = [status, n_null, n_neg]
        fmt = "{0:<10}{1:<10}{2:<10}"
        if self._last_kkt is not None:
            A = _np.asarray(self._last_kkt)
            xv = _np.asarray(x)
            r = _np.asarray(rhs) - A @ xv
            norm_a = float(_np.abs(A).max())
            norm_x = float(_np.abs(xv).max())
            max_r = float(_np.abs(r).max())
            rel = max_r / max(norm_a * norm_x, 1e-300)
            fields += [norm_a, norm_x, max_r, rel]
            fmt += "".join(
                "{" + str(i) + ":<15.3e}" for i in range(3, len(fields))
            )
        self.logger.info(fmt.format(*fields))


class SchurComplementLinearSolver(_SchurComplementSolver):
    """Reference ``parapint.linalg.SchurComplementLinearSolver``
    (explicit_schur_complement.py:16).  The reference takes one solver
    object per diagonal block; here the blocks are factored by one
    batched kernel, so per-block solver objects are accepted for signature
    compatibility but only the schur_complement_solver is used."""

    def __init__(self, subproblem_solvers=None, schur_complement_solver=None, **kwargs):
        super().__init__(schur_complement_solver=schur_complement_solver, **kwargs)


class MPISchurComplementLinearSolver(_ShardedSchurComplementSolver):
    """Reference ``parapint.linalg.MPISchurComplementLinearSolver``
    (mpi_explicit_schur_complement.py:128).  Takes a jax Mesh instead of an
    implicit MPI.COMM_WORLD."""

    def __init__(
        self,
        subproblem_solvers=None,
        schur_complement_solver=None,
        mesh=None,
        axis_name: str = "blocks",
        **kwargs,
    ):
        if mesh is None:
            raise ValueError(
                "MPISchurComplementLinearSolver requires mesh= (the JAX "
                "analogue of the MPI communicator)"
            )
        super().__init__(
            mesh,
            axis_name,
            schur_complement_solver=schur_complement_solver,
            **kwargs,
        )


# interface aliases: parallelism is a mesh argument, not a class
MPIDynamicSchurComplementInteriorPointInterface = (
    _pt.DynamicSchurComplementInteriorPointInterface
)
MPIStochasticSchurComplementInteriorPointInterface = (
    _pt.StochasticSchurComplementInteriorPointInterface
)

linalg = types.SimpleNamespace(
    LinearSolverInterface=_pt.LinearSolver,
    LinearSolverResults=_pt.LinearSolverResults,
    LinearSolverStatus=_pt.LinearSolverStatus,
    ScipyInterface=ScipyInterface,
    InteriorPointMA27Interface=InteriorPointMA27Interface,
    MumpsInterface=MumpsInterface,
    SchurComplementLinearSolver=SchurComplementLinearSolver,
    MPISchurComplementLinearSolver=MPISchurComplementLinearSolver,
)

interfaces = types.SimpleNamespace(
    BaseInteriorPointInterface=_pt.interfaces.base.BaseInteriorPointInterface,
    InteriorPointInterface=_pt.InteriorPointInterface,
    DynamicSchurComplementInteriorPointInterface=_pt.DynamicSchurComplementInteriorPointInterface,
    StochasticSchurComplementInteriorPointInterface=_pt.StochasticSchurComplementInteriorPointInterface,
    MPIDynamicSchurComplementInteriorPointInterface=MPIDynamicSchurComplementInteriorPointInterface,
    MPIStochasticSchurComplementInteriorPointInterface=MPIStochasticSchurComplementInteriorPointInterface,
)

algorithms = types.SimpleNamespace(
    InteriorPointStatus=_pt.InteriorPointStatus,
    IPOptions=_pt.IPOptions,
    ip_solve=_pt.ip_solve,
)
