"""Dynamic (time-block decomposition) Schur-complement interior-point interface.

JAX counterpart of the reference's
``DynamicSchurComplementInteriorPointInterface`` / ``MPIDynamic...``
(/root/reference/parapint/interfaces/schur_complement/sc_ip_interface.py:13-1025,
mpi_sc_ip_interface.py:32-270): the time horizon [start_t, end_t] is split
into N uniform time blocks; continuity of the ``num_states`` state variables
across block boundaries is enforced through coupling variables c and linear
linking constraints

    backward (block i > 0):    x_i[start_state_idx] - c_{i-1} = 0
    forward  (block i < N-1):  x_i[end_state_idx]   - c_i     = 0

Design differences from the reference (deliberate, device-first):

- All N blocks are one uniform batched model family (see
  :mod:`parapint_tpu.interfaces.blocked`); block 0's initial conditions are
  extra equality rows masked off in the other blocks, instead of per-block
  Pyomo models of different shapes.
- BOTH link families' dual rows live in the diagonal blocks (the reference
  keeps forward links in the coupling block, sc_ip_interface.py:316-334),
  so the Schur complement has dimension (N-1)*num_states — half the
  reference's 2*(N-1)*num_states — while the math stays an exact
  block-bordered elimination.
- The KKT is a :class:`LocalBlockKKT`: dense per-block diagonal blocks plus
  block-local border strips with static global-row maps (no runtime sparsity
  discovery).

Serial and parallel are the same class: pass a
:class:`ShardedSchurComplementSolver` (and optionally ``mesh=``) to run with
the block axis sharded over devices.
"""

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from parapint_tpu.interfaces.blocked import BatchedNLPFunctions, selector_rows
from parapint_tpu.interfaces.structured import StructuredSCInterface


@dataclasses.dataclass
class DynamicModelSpec:
    """Uniform batched model family for a dynamic optimization problem.

    The user-facing replacement for subclassing and implementing
    ``build_model_for_time_block`` (reference sc_ip_interface.py:108-141):
    one set of block functions shared by all time blocks, plus per-block
    parameters.

    Parameters
    ----------
    num_blocks: N, number of time blocks
    objective: (x, p) -> scalar, per-block objective (summed over blocks)
    eq_constraints: (x, p) -> (n_eq,); rows may be masked per block via
        eq_mask (e.g. initial conditions: real only in block 0)
    ineq_constraints: (x, p) -> (n_ineq,) or None
    params: pytree with leading dimension N (per-block data: time offsets,
        initial condition values, ...)
    x0: (N, n) initial primal values
    xl, xu: (N, n) variable bounds (default unbounded)
    gl, gu: (N, n_ineq) inequality bounds
    eq_mask / ineq_mask / x_mask: (N, dim) bool validity masks (default all
        valid)
    start_state_idx / end_state_idx: (num_states,) int indices into x of the
        states at the start/end of each block (the same for every block, as
        the reference requires — sc_ip_interface.py:127-130)
    """

    num_blocks: int
    objective: Callable
    eq_constraints: Optional[Callable]
    params: object
    x0: object
    start_state_idx: object
    end_state_idx: object
    ineq_constraints: Optional[Callable] = None
    xl: Optional[object] = None
    xu: Optional[object] = None
    gl: Optional[object] = None
    gu: Optional[object] = None
    eq_mask: Optional[object] = None
    ineq_mask: Optional[object] = None
    x_mask: Optional[object] = None
    # warm-start values from a prior solve (reference interface.py:262-282,
    # :621-649 initializes duals from ipopt suffixes); all optional:
    y_eq0: Optional[object] = None  # (N, n_eq) equality duals
    y_ineq0: Optional[object] = None  # (N, n_ineq) inequality duals
    zl0: Optional[object] = None  # (N, n) lower bound duals
    zu0: Optional[object] = None  # (N, n) upper bound duals
    lam0: Optional[object] = None  # (N, 2*num_states) link duals [bwd, fwd]
    c0: Optional[object] = None  # ((N-1)*num_states,) coupling values

    def __post_init__(self):
        N = self.num_blocks
        self.x0 = jnp.asarray(self.x0, dtype=jnp.float64)
        if self.x0.ndim != 2 or self.x0.shape[0] != N:
            raise ValueError(f"x0 must be (num_blocks, n), got {self.x0.shape}")
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

        self.start_state_idx = np.asarray(self.start_state_idx, dtype=np.int64)
        self.end_state_idx = np.asarray(self.end_state_idx, dtype=np.int64)
        if self.start_state_idx.shape != self.end_state_idx.shape:
            raise ValueError("start/end state index lists must have equal length")
        self.num_states = int(self.start_state_idx.shape[0])

        # enforce the padding invariant: masked vars/rows are unbounded
        self.xl[~self.x_mask] = -np.inf
        self.xu[~self.x_mask] = np.inf
        self.gl[~self.ineq_mask] = -np.inf
        self.gu[~self.ineq_mask] = np.inf

        # warm-start arrays: validate/broadcast when supplied
        def _warm(arr, shape):
            if arr is None:
                return None
            return jnp.broadcast_to(
                jnp.asarray(arr, dtype=jnp.float64), shape
            )

        ns = self.num_states
        self.y_eq0 = _warm(self.y_eq0, (N, me))
        self.y_ineq0 = _warm(self.y_ineq0, (N, mi))
        self.zl0 = _warm(self.zl0, (N, n))
        self.zu0 = _warm(self.zu0, (N, n))
        self.lam0 = _warm(self.lam0, (N, 2 * ns))
        self.c0 = _warm(self.c0, ((N - 1) * ns,))


class DynamicSchurComplementInteriorPointInterface(StructuredSCInterface):
    """Interface for dynamic problems (see module docstring).

    Parameters
    ----------
    spec: DynamicModelSpec
    mesh / axis_name: optional device mesh; when given, block-axis arrays are
        laid out sharded over ``axis_name`` so evaluation, assembly and the
        sharded Schur solver all run SPMD.
    """

    def __init__(
        self,
        spec: DynamicModelSpec,
        mesh=None,
        axis_name: str = "blocks",
        kkt_dtype=None,
        block_form: str = "dense",
    ):
        self.spec = spec
        N = spec.num_blocks
        n, me, mi, ns = spec.n_x, spec.n_eq, spec.n_ineq, spec.num_states
        self.N, self.n, self.me, self.mi, self.ns = N, n, me, mi, ns
        self.ncv = ns * (N - 1)
        self.n_link = 2 * ns

        self.fns = BatchedNLPFunctions(
            spec.objective, spec.eq_constraints, spec.ineq_constraints, n, me, mi
        )
        self.params = jax.tree_util.tree_map(jnp.asarray, spec.params)
        self.eq_mask = jnp.asarray(spec.eq_mask)
        self.ineq_mask = jnp.asarray(spec.ineq_mask)
        self.x_mask = jnp.asarray(spec.x_mask)
        self._xl, self._xu = spec.xl, spec.xu
        self._gl, self._gu = spec.gl, spec.gu
        self.x0 = spec.x0
        self._warm_start = dict(
            y_eq0=spec.y_eq0, y_ineq0=spec.y_ineq0, zl0=spec.zl0,
            zu0=spec.zu0, lam0=spec.lam0, c0=spec.c0,
        )

        # link structure: rows [0, ns) = backward, [ns, 2ns) = forward
        blk = np.arange(N)
        bwd_mask = np.broadcast_to((blk > 0)[:, None], (N, ns)).astype(np.float64)
        fwd_mask = np.broadcast_to((blk < N - 1)[:, None], (N, ns)).astype(np.float64)
        self.bwd_mask = jnp.asarray(bwd_mask)
        self.fwd_mask = jnp.asarray(fwd_mask)
        # structured selector form (see StructuredSCInterface.link_rows):
        # rows [0, ns) select start_state_idx (backward links), rows
        # [ns, 2ns) select end_state_idx (forward links)
        self._link_sel = jnp.asarray(
            np.concatenate([spec.start_state_idx, spec.end_state_idx]),
            jnp.int32,
        )
        self.link_mask = jnp.concatenate([self.bwd_mask, self.fwd_mask], axis=1)
        self._link_rows_mask = self.link_mask

        # coupling var touched by each link row: backward -> c_{i-1},
        # forward -> c_i; masked rows point at the dump index ncv
        DUMP = self.ncv
        row_idx = np.full((N, 2 * ns), DUMP, dtype=np.int32)
        for i in range(N):
            if i > 0:
                row_idx[i, :ns] = (i - 1) * ns + np.arange(ns)
            if i < N - 1:
                row_idx[i, ns:] = i * ns + np.arange(ns)
        self.row_idx = jnp.asarray(row_idx)

        # time-chain topology: the SC is block-tridiagonal; use the
        # scatter-free assembly (see LocalBlockKKT.assembly)
        self.sc_assembly = "chain"
        self._finalize(
            mesh=mesh,
            axis_name=axis_name,
            kkt_dtype=kkt_dtype,
            block_form=block_form,
        )

    # -- dynamic-specific accessors -----------------------------------------

    def get_duals_backward(self):
        """Duals of the backward continuity constraints, (N, num_states)."""
        return self._current_state.duals_eq["link"][:, : self.ns] * self.bwd_mask

    def get_duals_forward(self):
        return self._current_state.duals_eq["link"][:, self.ns :] * self.fwd_mask
