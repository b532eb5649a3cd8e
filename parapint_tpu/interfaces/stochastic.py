"""Two-stage stochastic Schur-complement interior-point interface.

JAX counterpart of the reference's
``StochasticSchurComplementInteriorPointInterface`` / ``MPIStochastic...``
(/root/reference/parapint/interfaces/schur_complement/sc_ip_interface.py:1028-1849,
mpi_sc_ip_interface.py:273-498): each scenario is one block; the coupling
variables c are the global first-stage variables; nonanticipativity is
enforced by the linear linking rows

    x_i[first_stage_idx[j]] - c[j] = 0      for every scenario i

whose dual rows live in the scenario's diagonal KKT block, so the Schur
complement has dimension n_first_stage (as in the reference).

The scenarios form one uniform batched model family (shared functions, a
per-scenario parameter pytree carrying yields/probabilities/...), evaluated
with one vmapped computation instead of per-scenario Pyomo NLPs.
"""

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from parapint_tpu.interfaces.blocked import BatchedNLPFunctions, selector_rows
from parapint_tpu.interfaces.structured import StructuredSCInterface


@dataclasses.dataclass
class StochasticModelSpec:
    """Uniform batched model family for a two-stage stochastic program.

    The user-facing replacement for implementing ``build_model_for_scenario``
    (reference sc_ip_interface.py:1122-1143).

    Parameters
    ----------
    num_scenarios: N
    objective: (x, p) -> scalar per-scenario objective.  As in the reference
        farmer example (stochastic.py:73), the scenario probability should be
        folded into the objective (via params).
    eq_constraints / ineq_constraints: (x, p) -> residuals (maskable)
    params: pytree with leading dimension N (scenario data)
    x0: (N, n) initial primals
    first_stage_idx: (L,) int, scenario-local indices of the first-stage
        variables — in the same order for every scenario (the reference's
        ``nonanticipative_var_identifiers`` ordering contract,
        sc_ip_interface.py:1043-1046)
    """

    num_scenarios: int
    objective: Callable
    params: object
    x0: object
    first_stage_idx: object
    eq_constraints: Optional[Callable] = None
    ineq_constraints: Optional[Callable] = None
    xl: Optional[object] = None
    xu: Optional[object] = None
    gl: Optional[object] = None
    gu: Optional[object] = None
    eq_mask: Optional[object] = None
    ineq_mask: Optional[object] = None
    x_mask: Optional[object] = None
    # warm-start values from a prior solve (reference interface.py:262-282,
    # :621-649); all optional:
    y_eq0: Optional[object] = None  # (N, n_eq) equality duals
    y_ineq0: Optional[object] = None  # (N, n_ineq) inequality duals
    zl0: Optional[object] = None  # (N, n) lower bound duals
    zu0: Optional[object] = None  # (N, n) upper bound duals
    lam0: Optional[object] = None  # (N, L) nonanticipativity duals
    c0: Optional[object] = None  # (L,) first-stage (coupling) values

    def __post_init__(self):
        N = self.num_scenarios
        self.x0 = jnp.asarray(self.x0, dtype=jnp.float64)
        if self.x0.ndim != 2 or self.x0.shape[0] != N:
            raise ValueError(f"x0 must be (num_scenarios, n), got {self.x0.shape}")
        n = self.x0.shape[1]
        p0 = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[0], self.params)
        if self.eq_constraints is not None:
            me = int(jax.eval_shape(self.eq_constraints, self.x0[0], p0).shape[0])
        else:
            me = 0
        if self.ineq_constraints is not None:
            mi = int(jax.eval_shape(self.ineq_constraints, self.x0[0], p0).shape[0])
        else:
            mi = 0
        self.n_x, self.n_eq, self.n_ineq = n, me, mi

        def _default(arr, shape, fill):
            if arr is None:
                return np.full(shape, fill)
            a = np.asarray(arr, dtype=np.float64)
            return np.broadcast_to(a, shape).copy()

        self.xl = _default(self.xl, (N, n), -np.inf)
        self.xu = _default(self.xu, (N, n), np.inf)
        self.gl = _default(self.gl, (N, mi), -np.inf)
        self.gu = _default(self.gu, (N, mi), np.inf)

        def _mask(m, shape):
            if m is None:
                return np.ones(shape, dtype=bool)
            return np.broadcast_to(np.asarray(m, dtype=bool), shape).copy()

        self.eq_mask = _mask(self.eq_mask, (N, me))
        self.ineq_mask = _mask(self.ineq_mask, (N, mi))
        self.x_mask = _mask(self.x_mask, (N, n))

        self.first_stage_idx = np.asarray(self.first_stage_idx, dtype=np.int64)
        self.n_first_stage = int(self.first_stage_idx.shape[0])

        self.xl[~self.x_mask] = -np.inf
        self.xu[~self.x_mask] = np.inf
        self.gl[~self.ineq_mask] = -np.inf
        self.gu[~self.ineq_mask] = np.inf

        def _warm(arr, shape):
            if arr is None:
                return None
            return jnp.broadcast_to(
                jnp.asarray(arr, dtype=jnp.float64), shape
            )

        L = self.n_first_stage
        self.y_eq0 = _warm(self.y_eq0, (N, me))
        self.y_ineq0 = _warm(self.y_ineq0, (N, mi))
        self.zl0 = _warm(self.zl0, (N, n))
        self.zu0 = _warm(self.zu0, (N, n))
        self.lam0 = _warm(self.lam0, (N, L))
        self.c0 = _warm(self.c0, (L,))


class StochasticSchurComplementInteriorPointInterface(StructuredSCInterface):
    """Interface for two-stage stochastic programs (see module docstring).

    Parameters
    ----------
    ownership_map: optional (N,) int array mapping scenario -> shard index,
        for load balancing when scenarios are heterogeneous in cost — the
        counterpart of the reference's user-supplied ``ownership_map``
        (mpi_sc_ip_interface.py:288-336).  Every shard must own the same
        number of scenarios (the sharded solver partitions the block axis
        evenly).  Internally this becomes a stable permutation ordering the
        scenario axis by shard before contiguous sharding; per-scenario
        accessors (``get_block_primals``) still take ORIGINAL scenario
        indices.  Requires ``mesh``.
    """

    def __init__(
        self,
        spec: StochasticModelSpec,
        mesh=None,
        axis_name: str = "blocks",
        kkt_dtype=None,
        ownership_map=None,
    ):
        self.spec = spec
        N = spec.num_scenarios
        n, me, mi = spec.n_x, spec.n_eq, spec.n_ineq
        L = spec.n_first_stage
        self.N, self.n, self.me, self.mi = N, n, me, mi
        self.ncv = L
        self.n_link = L

        # scenario -> shard ownership: reorder the scenario axis so each
        # shard's scenarios are contiguous (the sharded solver then assigns
        # them by plain contiguous sharding)
        if ownership_map is not None:
            if mesh is None:
                raise ValueError("ownership_map requires mesh")
            own = np.asarray(ownership_map, dtype=np.int64)
            if own.shape != (N,):
                raise ValueError(
                    f"ownership_map must be ({N},), got {own.shape}"
                )
            n_shards = mesh.shape[axis_name]
            if own.min() < 0 or own.max() >= n_shards:
                raise ValueError(
                    f"ownership_map entries must be in [0, {n_shards})"
                )
            counts = np.bincount(own, minlength=n_shards)
            if not np.all(counts == N // n_shards) or N % n_shards:
                raise ValueError(
                    "ownership_map must assign the same number of scenarios "
                    f"to every shard (got counts {counts.tolist()})"
                )
            perm = np.argsort(own, kind="stable")
        else:
            perm = np.arange(N)
        self.block_perm = perm  # storage order -> original scenario index
        self._inv_perm = np.argsort(perm)
        self._perm_is_identity = bool(np.array_equal(perm, np.arange(N)))

        def _p(a):
            """Permute the leading (scenario) axis into storage order."""
            return None if a is None else np.asarray(a)[perm]

        self.fns = BatchedNLPFunctions(
            spec.objective, spec.eq_constraints, spec.ineq_constraints, n, me, mi
        )
        self.params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a)[perm]), spec.params
        )
        self.eq_mask = jnp.asarray(_p(spec.eq_mask))
        self.ineq_mask = jnp.asarray(_p(spec.ineq_mask))
        self.x_mask = jnp.asarray(_p(spec.x_mask))
        self._xl, self._xu = _p(spec.xl), _p(spec.xu)
        self._gl, self._gu = _p(spec.gl), _p(spec.gu)
        self.x0 = jnp.asarray(_p(spec.x0))
        self._warm_start = dict(
            y_eq0=_p(spec.y_eq0), y_ineq0=_p(spec.y_ineq0), zl0=_p(spec.zl0),
            zu0=_p(spec.zu0), lam0=_p(spec.lam0), c0=spec.c0,
        )

        ones = np.ones((N, L))
        # structured selector form (see StructuredSCInterface.link_rows)
        self._link_sel = jnp.asarray(spec.first_stage_idx, jnp.int32)
        self.link_mask = jnp.asarray(ones)
        self._link_rows_mask = self.link_mask
        # every scenario's link row j targets coupling var j
        self.row_idx = jnp.asarray(
            np.broadcast_to(np.arange(L, dtype=np.int32), (N, L)).copy()
        )

        # every scenario links the same coupling rows 0..L-1: plain sum
        self.sc_assembly = "shared"
        self._finalize(mesh=mesh, axis_name=axis_name, kkt_dtype=kkt_dtype)

    # -- stochastic-specific accessors --------------------------------------
    #
    # With a non-trivial ownership_map the state is stored with the scenario
    # axis PERMUTED into shard-contiguous storage order.  Every accessor that
    # exposes a per-scenario axis de-permutes it back to ORIGINAL scenario
    # order, so round-tripping results into the warm-start spec fields
    # (documented as original order, and permuted again by ``_p``) assigns
    # values to the right scenarios.

    def _deperm(self, a):
        """De-permute a leading (scenario-storage) axis to ORIGINAL order."""
        if self._perm_is_identity:
            return a
        return a[jnp.asarray(self._inv_perm)]

    def get_block_primals(self, ndx: int):
        """Primals of ORIGINAL scenario ``ndx`` (ownership permutation
        applied)."""
        return self._current_state.primals["blocks"][self._inv_perm[ndx]]

    def get_first_stage_values(self):
        """Consensus first-stage variable values (the coupling variables)."""
        return self._current_state.primals["coupling"]

    def get_duals_nonanticipativity(self):
        """(N, L) nonanticipativity duals, in ORIGINAL scenario order."""
        return self._deperm(self._current_state.duals_eq["link"])

    def get_primals(self):
        p = self._current_state.primals
        return {"blocks": self._deperm(p["blocks"]), "coupling": p["coupling"]}

    def get_slacks(self):
        return self._deperm(self._current_state.slacks)

    def get_duals_eq(self):
        """{"own": (N, me), "link": (N, L)}, ORIGINAL scenario order."""
        d = self._current_state.duals_eq
        return {"own": self._deperm(d["own"]), "link": self._deperm(d["link"])}

    def get_duals_ineq(self):
        return self._deperm(self._current_state.duals_ineq)

    def _deperm_bound_duals(self, d):
        return {"blocks": self._deperm(d["blocks"]), "coupling": d["coupling"]}

    def get_duals_primals_lb(self):
        return self._deperm_bound_duals(self._current_state.duals_primals_lb)

    def get_duals_primals_ub(self):
        return self._deperm_bound_duals(self._current_state.duals_primals_ub)

    def get_duals_slacks_lb(self):
        return self._deperm(self._current_state.duals_slacks_lb)

    def get_duals_slacks_ub(self):
        return self._deperm(self._current_state.duals_slacks_ub)
