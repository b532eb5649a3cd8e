"""Generic block-structured Schur-complement interior-point interface.

Both problem geometries of the reference — dynamic time-block decomposition
and two-stage stochastic scenario decomposition
(/root/reference/parapint/interfaces/schur_complement/sc_ip_interface.py) —
are instances of one structure: N uniform NLP blocks, a vector c of coupling
variables, and per-block *linear linking rows*

    x_b[sel_j] - c[row_idx[b, j]] = 0      (j = 0..n_link-1, maskable)

whose dual rows live inside the block's diagonal KKT block and whose
coupling columns form the (block-local) border.  This class implements the
whole interior-point interface protocol for that structure; the dynamic and
stochastic classes only build the link topology.

Per-block KKT layout: [x(n), s(mi), y_eq(me), y_ineq(mi), lambda(n_link)],
see :func:`parapint_tpu.interfaces.blocked.sub_kkt_layout`.
"""

import jax
import jax.numpy as jnp
import numpy as np

from parapint_tpu.interfaces import base
from parapint_tpu.interfaces.base import Bounds, ConvergenceInfo, IPState
from parapint_tpu.interfaces.blocked import (
    BatchedNLPFunctions,
    BlockKKTData,
    assemble_block_diag,
    sub_kkt_layout,
)
from parapint_tpu.linalg.schur import BlockRhs, LocalBlockKKT


class StructuredSCInterface(base.BaseInteriorPointInterface):
    """Shared implementation; see module docstring.

    Subclass responsibilities (before calling ``_finalize``):
      self.N, self.n, self.me, self.mi, self.n_link, self.ncv
      self.fns (BatchedNLPFunctions), self.params
      self.eq_mask / ineq_mask / x_mask  (jnp, (N, dim))
      self.link_rows (N, n_link, n), self.link_mask (N, n_link)
      self.row_idx (N, n_link) int32 into [0, ncv] (ncv = dump)
      self.border_loc (N, n_link_border?, nk) with matching self.border_row_idx
      self._xl/_xu (N, n), self._gl/_gu (N, mi)  raw bounds
      self.x0 (N, n) initial primals
    """

    def _finalize(
        self,
        mesh=None,
        axis_name: str = "blocks",
        kkt_dtype=None,
        block_form: str = "dense",
    ):
        self.mesh = mesh
        self.axis_name = axis_name
        # block_form "banded": per-block KKTs are assembled as banded
        # matrices under a host-computed fill-reducing permutation (see
        # interfaces/banded_symbolic.py) and consumed by
        # linalg.banded_schur.BandedSchurComplementSolver — the MA27
        # sparse-envelope analogue for PDE block families where the dense
        # (N, nk, nk) materialization is infeasible
        # (/root/reference/parapint/linalg/ma27_interface.py:9-256).
        if block_form not in ("dense", "banded"):
            raise ValueError(f"unknown block_form {block_form!r}")
        self.block_form = block_form
        # kkt_dtype (e.g. jnp.float32): evaluate the Hessian AD sweep and
        # assemble the KKT *matrix* data in this dtype.  The matrix feeds a
        # factor_dtype=f32 factorization anyway, so nothing downstream loses
        # accuracy, while the most expensive AD sweep (fwd-over-rev Hessian)
        # and the largest assembly traffic (the (N, nk, nk) diag blocks) run
        # at half the bytes/flops.  Everything convergence-critical — rhs,
        # gradients, constraint residuals, infeasibility norms — stays in
        # the working (f64) precision: those are vectors, cheap to keep
        # exact, and tol=1e-8 cannot be certified from f32 residuals.
        # Caveat: iterative refinement then corrects toward the rounded
        # matrix (backward error ~eps_f32); leave unset for solvers relying
        # on f64-refined step accuracy.
        self.kkt_dtype = kkt_dtype
        if kkt_dtype is not None:
            self._params_kkt = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a).astype(kkt_dtype)
                if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
                else jnp.asarray(a),
                self.params,
            )
        else:
            self._params_kkt = self.params
        if not hasattr(self, "sc_assembly"):
            self.sc_assembly = "scatter"
        (
            self.off_x,
            self.off_s,
            self.off_yeq,
            self.off_yineq,
            self.off_lam,
            self.nk,
        ) = sub_kkt_layout(self.n, self.me, self.mi, self.n_link)
        self.obj_factor = 1.0
        self._current_state = None

        # border: the coupling-column entries of the link rows — local
        # border row j couples c[row_idx[b, j]] to the lambda_j column with
        # -1, i.e. border_loc = -link_mask on an identity strip at column
        # off_lam.  Built LAZILY on device (see the border_loc property):
        # materializing it as a closure constant embeds O(N * n_link * nk)
        # floats in every jitted graph's HLO — at the reference's flagship
        # scaling knob (Burgers nfe_x=200: 64 x 402 x 3017 f64 = 620 MB)
        # that bloats every compile request.
        lm = np.asarray(self.link_mask)

        if block_form == "banded":
            self._banded_setup()

        self.n_eq_real = int(np.asarray(self.eq_mask).sum()) + int(lm.sum())
        self.n_ineq_real = int(np.asarray(self.ineq_mask).sum())

        self._bounds_relaxation_factor = 0.0
        self._set_bounds()

        self._convergence_info = jax.jit(self._convergence_info_impl)
        self._eval_kkt_data = jax.jit(self._eval_kkt_data_impl)
        self._assemble_kkt = jax.jit(self._assemble_kkt_impl)
        self._extract_deltas = jax.jit(self._extract_deltas_impl)
        self._fraction_to_the_boundary = jax.jit(self._ftb_impl)
        self._apply_step = jax.jit(self._apply_step_impl)

    # -- structured (HLO-constant-free) link/border tensors ------------------
    #
    # link_rows and border_loc are structurally one-hot: row j selects one
    # column with a masked +-1.  Building the dense (N, L, n) tensors
    # inside the trace from iota comparisons keeps them OUT of the HLO as
    # constants (620 MB at nfe_x=200) while XLA
    # still fuses/materializes them as needed at runtime.

    @property
    def border_loc(self):
        L = self.n_link
        dt = self.link_mask.dtype
        oh = (
            jnp.arange(L, dtype=jnp.int32)[:, None] + jnp.int32(self.off_lam)
            == jnp.arange(self.nk, dtype=jnp.int32)[None, :]
        ).astype(dt)
        return -self.link_mask[:, :, None] * oh[None]

    @property
    def _border_loc_perm(self):
        """border_loc with banded-permuted columns, built in-trace from the
        (L,) position selector computed at _banded_setup time."""
        pos = self._b_border_pos
        dt = self.link_mask.dtype
        oh = (
            pos[:, None] == jnp.arange(self.nk, dtype=jnp.int32)[None, :]
        ).astype(dt)
        return -self.link_mask[:, :, None] * oh[None]

    @property
    def link_rows(self):
        sel = getattr(self, "_link_sel", None)
        if sel is None:
            return self._link_rows_dense
        dt = self.link_mask.dtype
        oh = (
            sel[:, None] == jnp.arange(self.n, dtype=sel.dtype)[None, :]
        ).astype(dt)
        return self._link_rows_mask[:, :, None] * oh[None]

    @link_rows.setter
    def link_rows(self, value):
        # general (non-selector) interfaces assign a dense tensor directly
        self._link_rows_dense = value
        self._link_sel = None

    # -- banded block form ---------------------------------------------------

    def _banded_setup(self):
        """One-time host symbolic analysis (ordering, bandwidth, probes) —
        the analogue of MA27's symbolic factorization.  See
        interfaces/banded_symbolic.py."""
        from parapint_tpu.interfaces import banded_symbolic as bs

        params_samples = [
            jax.tree_util.tree_map(lambda a: jnp.asarray(a)[i], self.params)
            for i in sorted({0, self.N - 1})
        ]
        Hpat, Jeq_pat, Jineq_pat = bs.block_patterns(
            self.fns, params_samples, self.n, self.me, self.mi
        )
        link_pat = np.abs(np.asarray(self.link_rows)).max(axis=0) > 0
        plan = bs.banded_plan(
            Hpat, Jeq_pat, Jineq_pat, link_pat,
            self.n, self.me, self.mi, self.n_link,
        )
        self.banded_plan = plan
        as_j = lambda a: jnp.asarray(a)
        self._b_perm = as_j(plan.perm.astype(np.int32))
        self._b_iperm = as_j(plan.iperm.astype(np.int32))
        self._b_Vx = as_j(plan.Vx)
        self._b_Vs = as_j(plan.Vs)
        self._b_Vyeq = as_j(plan.Vyeq)
        self._b_Vyineq = as_j(plan.Vyineq)
        self._b_Vlam = as_j(plan.Vlam)
        self._b_col_idx = as_j(plan.col_idx.astype(np.int32))
        self._b_row_idx = as_j(plan.row_idx.astype(np.int32))
        self._b_valid = as_j(plan.valid)
        # border strips with permuted columns: structurally one-hot — local
        # border row j holds -link_mask[b, j] at permuted column
        # iperm[off_lam + j] (perm[i] == off_lam + j  <=>  i == iperm[...]).
        # Stored as the tiny (L,) position selector and built in-trace by
        # the _border_loc_perm property: materializing the dense (N, L, nk)
        # tensor here made it a closure constant of every jitted graph —
        # 620 MB of HLO at the Burgers nfe_x=200 flagship knob.
        self._b_border_pos = as_j(
            plan.iperm.astype(np.int32)[
                self.off_lam : self.off_lam + self.n_link
            ]
        )
        # regularization diagonal masks in permuted space (N, nk):
        # w_reg ADDS to real x-variable diagonals; c_reg SETs real
        # constraint diagonals (assemble_block_diag semantics)
        N, nk = self.N, self.nk
        w_mask = np.zeros((N, nk))
        w_mask[:, : self.n] = np.asarray(self.x_mask, dtype=np.float64)
        c_mask = np.zeros((N, nk))
        c_mask[:, self.off_yeq : self.off_yeq + self.me] = np.asarray(
            self.eq_mask, dtype=np.float64
        )
        c_mask[:, self.off_yineq : self.off_yineq + self.mi] = np.asarray(
            self.ineq_mask, dtype=np.float64
        )
        c_mask[:, self.off_lam :] = np.asarray(self.link_mask, dtype=np.float64)
        self._b_w_mask = as_j(w_mask[:, plan.perm])
        self._b_c_mask = as_j(c_mask[:, plan.perm])

    def _banded_bands0(self, state, sigma_x, sigma_s):
        """Per-iteration banded KKT assembly by probing: (N, p+1, nk) lower
        bands of the permuted per-block KKTs at w_reg = c_reg = 0.

        Mirrors assemble_block_diag's entries exactly, in matvec form: the
        2p+1 probe columns are applied through HVP/JVP/VJP sweeps (no
        (N, n, n) Hessian ever exists)."""
        fns = self.fns
        kd = self.kkt_dtype
        if kd is None:
            cast = lambda a: a
            params = self.params
        else:
            cast = lambda a: (
                a.astype(kd)
                if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
                else a
            )
            params = self._params_kkt
        x = cast(state.primals["blocks"])
        yeq = cast(state.duals_eq["own"])
        yineq = cast(state.duals_ineq)
        dt = x.dtype
        xm = self.x_mask
        em = self.eq_mask.astype(dt)
        im = self.ineq_mask.astype(dt)
        lm = self.link_mask.astype(dt)
        obf = jnp.full(self.N, self.obj_factor, dtype=dt)
        Vx = self._b_Vx.astype(dt)
        Vs = self._b_Vs.astype(dt)
        Vyeq = self._b_Vyeq.astype(dt)
        Vyineq = self._b_Vyineq.astype(dt)
        Vlam = self._b_Vlam.astype(dt)
        lrows = self.link_rows.astype(dt)
        sx = cast(sigma_x)
        ss = cast(sigma_s)

        hv = fns.hvp_lag(x, yeq, yineq, obf, params, xm, em, im, Vx)
        jeq_v = fns.jvp_eq(x, params, xm, em, Vx)
        jineq_v = fns.jvp_ineq(x, params, xm, im, Vx)
        jTeq_v = fns.vjp_eq(x, params, xm, em, Vyeq)
        jTineq_v = fns.vjp_ineq(x, params, xm, im, Vyineq)

        out_x = (
            hv
            + jnp.where(xm, sx, 1.0).astype(dt)[:, None, :] * Vx[None]
            + jTeq_v
            + jTineq_v
            + jnp.einsum("bln,ql->bqn", lrows, Vlam, preferred_element_type=dt)
        )
        out_s = (
            jnp.where(self.ineq_mask, ss, 1.0).astype(dt)[:, None, :] * Vs[None]
            - im[:, None, :] * Vyineq[None]
        )
        out_yeq = jeq_v + jnp.where(self.eq_mask, 0.0, -1.0).astype(dt)[
            :, None, :
        ] * Vyeq[None]
        out_yineq = (
            jineq_v
            - im[:, None, :] * Vs[None]
            + jnp.where(self.ineq_mask, 0.0, -1.0).astype(dt)[:, None, :]
            * Vyineq[None]
        )
        out_lam = jnp.einsum(
            "bln,qn->bql", lrows, Vx, preferred_element_type=dt
        ) + jnp.where(self.link_mask > 0, 0.0, -1.0).astype(dt)[:, None, :] * Vlam[None]
        Y = jnp.concatenate([out_x, out_s, out_yeq, out_yineq, out_lam], axis=2)
        # permute ROWS (K v is a row-space vector), then extract bands:
        # bands0[b, e, i] = Kp[i+e, i] = Yp[b, i % q, i + e]
        Yp = jnp.take(Y, self._b_perm, axis=2)
        bands0 = Yp[:, self._b_col_idx, self._b_row_idx] * self._b_valid.astype(dt)
        return bands0

    # -- parity accessors --------------------------------------------------

    def n_primals(self) -> int:
        return self.N * self.n + self.ncv

    def n_eq_constraints(self) -> int:
        """Includes the coupling constraints (reference sc_ip_interface.py:593-600)."""
        return self.n_eq_real

    def n_ineq_constraints(self) -> int:
        return self.n_ineq_real

    @property
    def n_duals_eq(self) -> int:
        return self.n_eq_real

    @property
    def n_duals_ineq(self) -> int:
        return self.n_ineq_real

    @property
    def expected_neg_eig(self) -> int:
        """All constraint-family rows, real or padded (padded rows carry a
        decoupled -1 diagonal, contributing one negative eigenvalue each;
        reference expectation: interior_point.py:379-381)."""
        return self.N * (self.me + self.mi + self.n_link)

    def get_state(self) -> IPState:
        return self._current_state

    def get_primals(self):
        return self._current_state.primals

    def get_block_primals(self, ndx: int):
        return self._current_state.primals["blocks"][ndx]

    def get_coupling_values(self):
        return self._current_state.primals["coupling"]

    def evaluate_objective(self):
        x = self._current_state.primals["blocks"]
        return self.fns.total_objective(x, self.params, self.x_mask)

    def get_slacks(self):
        return self._current_state.slacks

    def get_duals_eq(self):
        """{"own": (N, me), "link": (N, n_link)} (the reference's 3-block
        eq-dual structure, sc_ip_interface.py:700-716, with both link
        families in "link")."""
        return self._current_state.duals_eq

    def get_duals_ineq(self):
        return self._current_state.duals_ineq

    def get_duals_primals_lb(self):
        return self._current_state.duals_primals_lb

    def get_duals_primals_ub(self):
        return self._current_state.duals_primals_ub

    def get_duals_slacks_lb(self):
        return self._current_state.duals_slacks_lb

    def get_duals_slacks_ub(self):
        return self._current_state.duals_slacks_ub

    # -- bounds ------------------------------------------------------------

    def get_bounds_relaxation_factor(self) -> float:
        return self._bounds_relaxation_factor

    def set_bounds_relaxation_factor(self, val: float) -> None:
        self._bounds_relaxation_factor = val
        self._set_bounds()

    def _set_bounds(self) -> None:
        f = self._bounds_relaxation_factor
        inf = jnp.inf
        self.bounds = Bounds(
            xl={
                "blocks": base.relax_bounds_lower(jnp.asarray(self._xl), f),
                "coupling": jnp.full(self.ncv, -inf),
            },
            xu={
                "blocks": base.relax_bounds_upper(jnp.asarray(self._xu), f),
                "coupling": jnp.full(self.ncv, inf),
            },
            gl=base.relax_bounds_lower(jnp.asarray(self._gl), f),
            gu=base.relax_bounds_upper(jnp.asarray(self._gu), f),
        )

    # -- sharding ----------------------------------------------------------

    def _shard_blocks(self, tree):
        """Constrain block-axis arrays to the mesh (no-op without a mesh)."""
        if self.mesh is None:
            return tree
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(self.mesh, P(self.axis_name))
        return jax.tree_util.tree_map(
            lambda a: jax.lax.with_sharding_constraint(a, sh), tree
        )

    # -- initial state ------------------------------------------------------

    def init_state(self) -> IPState:
        b = self.bounds
        base.validate_bounds(np.asarray(b.xl["blocks"]), np.asarray(b.xu["blocks"]))
        base.validate_bounds(np.asarray(b.gl), np.asarray(b.gu))
        # warm-start values from a prior solve, when the spec supplies them
        # (reference interface.py:262-282 and :621-649 initializes all four
        # bound-dual families plus eq/ineq duals from ipopt suffixes)
        warm = getattr(self, "_warm_start", {}) or {}
        y_eq0 = warm.get("y_eq0")
        y_ineq0 = warm.get("y_ineq0")
        zl0 = warm.get("zl0")
        zu0 = warm.get("zu0")
        lam0 = warm.get("lam0")
        c0 = warm.get("c0")
        x = base.process_init(self.x0, b.xl["blocks"], b.xu["blocks"])
        c = jnp.zeros(self.ncv) if c0 is None else jnp.asarray(c0)
        s0 = self.fns.c_ineq(self.x0, self.params, self.x_mask, self.ineq_mask)
        s = base.process_init(s0, b.gl, b.gu)
        zl_w = jnp.ones((self.N, self.n)) if zl0 is None else jnp.asarray(zl0)
        zu_w = jnp.ones((self.N, self.n)) if zu0 is None else jnp.asarray(zu0)
        zl = base.process_init_duals_lb(
            jnp.where(jnp.isneginf(b.xl["blocks"]), 0.0, zl_w), b.xl["blocks"]
        )
        zu = base.process_init_duals_ub(
            jnp.where(jnp.isposinf(b.xu["blocks"]), 0.0, zu_w), b.xu["blocks"]
        )
        # slack duals split from warm ineq duals by sign (interface.py:275-279)
        vl_w = (
            jnp.zeros((self.N, self.mi))
            if y_ineq0 is None
            else jnp.maximum(jnp.asarray(y_ineq0), 0.0)
        )
        vu_w = (
            jnp.zeros((self.N, self.mi))
            if y_ineq0 is None
            else jnp.maximum(-jnp.asarray(y_ineq0), 0.0)
        )
        vl = base.process_init_duals_lb(vl_w, b.gl)
        vu = base.process_init_duals_ub(vu_w, b.gu)
        zeros_c = jnp.zeros(self.ncv)
        state = IPState(
            primals={"blocks": x, "coupling": c},
            slacks=s,
            duals_eq={
                "own": (
                    jnp.zeros((self.N, self.me))
                    if y_eq0 is None
                    else jnp.asarray(y_eq0)
                ),
                "link": (
                    jnp.zeros((self.N, self.n_link))
                    if lam0 is None
                    else jnp.asarray(lam0) * self.link_mask
                ),
            },
            duals_ineq=(
                jnp.zeros((self.N, self.mi))
                if y_ineq0 is None
                else jnp.asarray(y_ineq0)
            ),
            duals_primals_lb={"blocks": zl, "coupling": zeros_c},
            duals_primals_ub={"blocks": zu, "coupling": zeros_c},
            duals_slacks_lb=vl,
            duals_slacks_ub=vu,
        )
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            n_shards = self.mesh.shape[self.axis_name]
            # non-divisible block counts: the iterate stays replicated (the
            # sharded SOLVER still pads/shards its own block axis via
            # pad_block_count, so the factorization work parallelizes; only
            # the O(N*nk) iterate vectors replicate)
            divisible = self.N % n_shards == 0
            shard = NamedSharding(
                self.mesh, P(self.axis_name) if divisible else P()
            )
            repl = NamedSharding(self.mesh, P())

            def place(a):
                sharding = (
                    shard if a.ndim >= 1 and a.shape[0] == self.N else repl
                )
                # make_array_from_callback (not device_put): works when the
                # mesh spans multiple processes — every process contributes
                # the shards its local devices own (the iterate is built
                # identically on all processes)
                host = np.asarray(a)
                return jax.make_array_from_callback(
                    host.shape, sharding, lambda idx: host[idx]
                )

            state = jax.tree_util.tree_map(place, state)
        return state

    # -- link helpers -------------------------------------------------------

    @property
    def _chain_links(self) -> bool:
        """Chain topology with the [bwd(ns), fwd(ns)] link layout: the
        coupling gather/scatter become shifted contiguous slices (pure
        data movement instead of scatters/gathers)."""
        ns = getattr(self, "ns", 0)
        return (
            self.sc_assembly == "chain"
            and ns > 0
            and self.n_link == 2 * ns
            and self.ncv == (self.N - 1) * ns
        )

    def _gather_coupling(self, c):
        """c values seen by each block's link rows: (N, n_link)."""
        if self._chain_links:
            ns = self.ns
            z = jnp.zeros((1, ns), dtype=c.dtype)
            ext = jnp.concatenate([z, c.reshape(-1, ns), z], axis=0)
            # bwd rows of block b read group b-1 = ext[b]; fwd read ext[b+1]
            return jnp.concatenate(
                [ext[: self.N], ext[1 : self.N + 1]], axis=1
            )
        c_pad = jnp.concatenate([c, jnp.zeros(1, dtype=c.dtype)])
        return c_pad[self.row_idx]

    def _link_duals(self, duals_eq):
        return duals_eq["link"] * self.link_mask

    def _link_resid(self, x, c):
        """(N, n_link) masked link residuals sel(x) - c."""
        # batched GEMM, not einsum "bln,bn->bl" (see _border_apply_chain in
        # linalg/schur.py)
        lx = jnp.matmul(self.link_rows.astype(x.dtype), x[:, :, None])[..., 0]
        return (lx - self._gather_coupling(c) * self.link_mask) * self.link_mask

    def _scatter_link_duals_to_coupling(self, duals_eq):
        lam = self._link_duals(duals_eq)
        if self._chain_links:
            ns = self.ns
            # group g collects fwd duals of block g and bwd duals of g+1
            return (lam[: self.N - 1, ns:] + lam[1:, :ns]).reshape(self.ncv)
        out = jnp.zeros(self.ncv + 1)
        out = out.at[self.row_idx].add(lam)
        return out[: self.ncv]

    def _grad_lag_primals(self, state, jac_eq, jac_ineq, grad_f, jtlam=None):
        if jtlam is None:
            jtlam = (
                jnp.matmul(state.duals_eq["own"][:, None, :], jac_eq)[:, 0, :]
                + jnp.matmul(state.duals_ineq[:, None, :], jac_ineq)[:, 0, :]
            )
        lam = self._link_duals(state.duals_eq)
        return (
            self.obj_factor * grad_f
            + jtlam
            + jnp.matmul(
                lam[:, None, :], self.link_rows.astype(lam.dtype)
            )[:, 0, :]
        )

    def _jtprod(self, state):
        """Exact (working-precision) J^T-dual product via one VJP sweep —
        no Jacobian materialization; see BatchedNLPFunctions.jtprod."""
        fns = self.fns
        if not hasattr(fns, "jtprod"):
            return None
        return fns.jtprod(
            state.primals["blocks"],
            state.duals_eq["own"],
            state.duals_ineq,
            self.params,
            self.x_mask,
            self.eq_mask,
            self.ineq_mask,
        )

    # -- shared AD evaluation (fused path) -----------------------------------

    def _eval_hess(self, state):
        """Hessian-of-Lagrangian sweep, in ``kkt_dtype`` when configured.

        The Hessian appears only in the KKT matrix (never in the rhs or the
        convergence norms), so evaluating the fwd-over-rev sweep — the most
        expensive AD computation of the iteration — at reduced precision
        perturbs the Newton *matrix* by O(eps_f32) without touching the
        f64 residuals; equivalent to quasi-Newton-level model error, far
        below what the interior point tolerates."""
        kd = self.kkt_dtype
        if kd is None:
            cast = lambda a: a
            params = self.params
        else:
            cast = lambda a: (
                a.astype(kd)
                if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
                else a
            )
            params = self._params_kkt
        return self.fns.hess_lag(
            cast(state.primals["blocks"]),
            cast(state.duals_eq["own"]),
            cast(state.duals_ineq),
            jnp.full(self.N, self.obj_factor, dtype=kd) if kd is not None
            else jnp.full(self.N, self.obj_factor),
            params,
            cast(self.x_mask),
            cast(self.eq_mask),
            cast(self.ineq_mask),
        )

    def _eval_jacs(self, state):
        """Materialized constraint Jacobians — in ``kkt_dtype`` when set.

        The materialized J only ever enters the KKT *matrix*; the dual
        contraction the f64 rhs/convergence path needs is computed exactly
        by :meth:`_jtprod` instead, so in mixed-precision mode the ~n_x
        forward sweeps of jacfwd run at f32 cost and nothing downstream
        loses f64 accuracy."""
        fns = self.fns
        if self.block_form == "banded":
            # never materialize (N, me, n) Jacobians in banded mode; every
            # consumer uses the VJP dual contraction (_jtprod) instead
            return None, None
        kd = self.kkt_dtype
        if kd is None or not hasattr(fns, "jtprod"):
            x = state.primals["blocks"]
            args = (x, self.params, self.x_mask)
            return fns.jac_eq(*args, self.eq_mask), fns.jac_ineq(
                *args, self.ineq_mask
            )
        cast = lambda a: (
            a.astype(kd)
            if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
            else a
        )
        args = (
            cast(state.primals["blocks"]),
            self._params_kkt,
            cast(self.x_mask),
        )
        return fns.jac_eq(*args, cast(self.eq_mask)), fns.jac_ineq(
            *args, cast(self.ineq_mask)
        )

    def eval_ad(self, state):
        """One AD sweep per iteration: every derivative quantity both the
        convergence check and the KKT assembly need.  The Python-loop
        ip_solve keeps the reference's separate evaluations; the fused
        solver shares this bundle between both consumers."""
        fns = self.fns
        x = state.primals["blocks"]
        args = (x, self.params, self.x_mask)
        jac_eq, jac_ineq = self._eval_jacs(state)
        # default (f64) mode: the materialized Jacobians exist anyway, so
        # the einsum fallback is free — skip the extra VJP sweep.  Banded
        # mode never materializes Jacobians or the Hessian (the KKT matrix
        # data is probed in kkt_from_ad instead) and so always needs jtlam.
        banded = self.block_form == "banded"
        jtlam = (
            self._jtprod(state)
            if (self.kkt_dtype is not None or banded)
            else None
        )
        return dict(
            obj=fns.total_objective(*args),
            grad_f=fns.grad_f(*args),
            jac_eq=jac_eq,
            jac_ineq=jac_ineq,
            jtlam=jtlam,
            c_eq=fns.c_eq(*args, self.eq_mask),
            c_ineq=fns.c_ineq(*args, self.ineq_mask),
            hess=None if banded else self._eval_hess(state),
        )

    def convergence_from_ad(self, state, ad, barrier, error_scaling):
        return self._convergence_core(
            state,
            self.bounds,
            ad["obj"],
            ad["grad_f"],
            ad["jac_eq"],
            ad["jac_ineq"],
            ad["c_eq"],
            ad["c_ineq"],
            barrier,
            error_scaling,
            jtlam=ad.get("jtlam"),
        )

    def kkt_from_ad(self, state, ad, barrier):
        return self._kkt_core(
            state,
            self.bounds,
            ad["hess"],
            ad["grad_f"],
            ad["jac_eq"],
            ad["jac_ineq"],
            ad["c_eq"],
            ad["c_ineq"],
            barrier,
            jtlam=ad.get("jtlam"),
        )

    # -- convergence ---------------------------------------------------------

    def convergence_info(self, state, barrier, error_scaling=100.0) -> ConvergenceInfo:
        return self._convergence_info(state, self.bounds, barrier, error_scaling)

    def _convergence_info_impl(self, state, bounds, barrier, error_scaling):
        fns = self.fns
        x = state.primals["blocks"]
        args = (x, self.params, self.x_mask)
        jac_eq, jac_ineq = self._eval_jacs(state)
        return self._convergence_core(
            state,
            bounds,
            fns.total_objective(*args),
            fns.grad_f(*args),
            jac_eq,
            jac_ineq,
            fns.c_eq(*args, self.eq_mask),
            fns.c_ineq(*args, self.ineq_mask),
            barrier,
            error_scaling,
            jtlam=self._jtprod(state),
        )

    def _convergence_core(
        self, state, bounds, obj, grad_f, jac_eq, jac_ineq, c_eq, c_ineq,
        barrier, error_scaling, jtlam=None,
    ):
        x = state.primals["blocks"]
        c = state.primals["coupling"]
        eq_resid_own = c_eq
        ineq_resid = c_ineq - state.slacks
        link_resid = self._link_resid(x, c)

        glp_blocks = (
            self._grad_lag_primals(state, jac_eq, jac_ineq, grad_f, jtlam)
            - state.duals_primals_lb["blocks"]
            + state.duals_primals_ub["blocks"]
        )
        glp_coupling = -self._scatter_link_duals_to_coupling(state.duals_eq)
        grad_lag_primals = jnp.concatenate([glp_blocks.reshape(-1), glp_coupling])
        grad_lag_slacks = (
            -state.duals_ineq - state.duals_slacks_lb + state.duals_slacks_ub
        )

        return base.convergence_metrics(
            objective=obj,
            grad_lag_primals=grad_lag_primals,
            grad_lag_slacks=grad_lag_slacks.reshape(-1),
            eq_resid=jnp.concatenate(
                [eq_resid_own.reshape(-1), link_resid.reshape(-1)]
            ),
            ineq_resid=ineq_resid.reshape(-1),
            primals=jnp.concatenate([x.reshape(-1), c]),
            primals_lb=jnp.concatenate(
                [bounds.xl["blocks"].reshape(-1), bounds.xl["coupling"]]
            ),
            primals_ub=jnp.concatenate(
                [bounds.xu["blocks"].reshape(-1), bounds.xu["coupling"]]
            ),
            duals_primals_lb=jnp.concatenate(
                [
                    state.duals_primals_lb["blocks"].reshape(-1),
                    state.duals_primals_lb["coupling"],
                ]
            ),
            duals_primals_ub=jnp.concatenate(
                [
                    state.duals_primals_ub["blocks"].reshape(-1),
                    state.duals_primals_ub["coupling"],
                ]
            ),
            slacks=state.slacks.reshape(-1),
            ineq_lb=bounds.gl.reshape(-1),
            ineq_ub=bounds.gu.reshape(-1),
            duals_slacks_lb=state.duals_slacks_lb.reshape(-1),
            duals_slacks_ub=state.duals_slacks_ub.reshape(-1),
            duals_eq=jnp.concatenate(
                [
                    state.duals_eq["own"].reshape(-1),
                    self._link_duals(state.duals_eq).reshape(-1),
                ]
            ),
            duals_ineq=state.duals_ineq.reshape(-1),
            n_duals_eq=self.n_eq_real,
            n_duals_ineq=self.n_ineq_real,
            barrier=barrier,
            error_scaling=error_scaling,
        )

    # -- line-search merit ---------------------------------------------------

    def merit_components(self, state, barrier):
        """(theta, phi) for the filter line search: theta = 1-norm of all
        constraint residuals (eq + ineq-slack + link), phi = barrier
        objective.  Values-only — no AD sweep — so a line-search trial costs
        a small fraction of an iteration."""
        fns = self.fns
        x = state.primals["blocks"]
        c = state.primals["coupling"]
        s = state.slacks
        args = (x, self.params, self.x_mask)
        obj = fns.total_objective(*args)
        c_eq = fns.c_eq(*args, self.eq_mask)
        c_ineq = fns.c_ineq(*args, self.ineq_mask)
        link = self._link_resid(x, c)
        theta = (
            jnp.sum(jnp.abs(c_eq))
            + jnp.sum(jnp.abs(c_ineq - s))
            + jnp.sum(jnp.abs(link))
        )
        b = self.bounds
        phi = self.obj_factor * obj - barrier * (
            base.log_barrier_sum(x, b.xl["blocks"], b.xu["blocks"])
            + base.log_barrier_sum(s, b.gl, b.gu)
        )
        return theta, phi

    # -- KKT evaluation ------------------------------------------------------

    def eval_kkt_data(self, state, barrier):
        return self._eval_kkt_data(state, self.bounds, barrier)

    def _eval_kkt_data_impl(self, state, bounds, barrier):
        fns = self.fns
        x = state.primals["blocks"]
        args = (x, self.params, self.x_mask)
        if self.block_form == "banded":
            return self._kkt_core_banded(
                state,
                bounds,
                fns.grad_f(*args),
                fns.c_eq(*args, self.eq_mask),
                fns.c_ineq(*args, self.ineq_mask),
                barrier,
            )
        hess = self._eval_hess(state)
        jac_eq, jac_ineq = self._eval_jacs(state)
        return self._kkt_core(
            state,
            bounds,
            hess,
            fns.grad_f(*args),
            jac_eq,
            jac_ineq,
            fns.c_eq(*args, self.eq_mask),
            fns.c_ineq(*args, self.ineq_mask),
            barrier,
            jtlam=self._jtprod(state) if self.kkt_dtype is not None else None,
        )

    def _kkt_core_banded(self, state, bounds, grad_f, c_eq, c_ineq, barrier):
        """Banded-mode (data, rhs): matrix data is the (N, p+1, nk) band
        store; the rhs uses the exact VJP dual contraction (no Jacobians)."""
        return self._kkt_core(
            state,
            bounds,
            None,
            grad_f,
            None,
            None,
            c_eq,
            c_ineq,
            barrier,
            jtlam=self._jtprod(state),
        )

    def _kkt_core(
        self, state, bounds, hess, grad_f, jac_eq, jac_ineq, c_eq, c_ineq,
        barrier, jtlam=None,
    ):
        x = state.primals["blocks"]
        c = state.primals["coupling"]
        s = state.slacks
        sigma_x = base.barrier_hessian_diag(
            x,
            bounds.xl["blocks"],
            bounds.xu["blocks"],
            state.duals_primals_lb["blocks"],
            state.duals_primals_ub["blocks"],
        )
        sigma_s = base.barrier_hessian_diag(
            s, bounds.gl, bounds.gu, state.duals_slacks_lb, state.duals_slacks_ub
        )
        # matrix data in kkt_dtype (see _finalize); the rhs below stays f64
        kd = self.kkt_dtype
        mcast = (lambda a: a) if kd is None else (lambda a: a.astype(kd))
        if self.block_form == "banded":
            # (N, p+1, nk) banded matrix data by probing — no (N, n, n)
            # Hessian or (N, me, n) Jacobian is ever materialized
            data = self._shard_blocks(
                self._banded_bands0(state, sigma_x, sigma_s)
            )
        else:
            data = BlockKKTData(
                hess=self._shard_blocks(mcast(hess)),
                jac_eq=self._shard_blocks(mcast(jac_eq)),
                jac_ineq=self._shard_blocks(mcast(jac_ineq)),
                sigma_x=self._shard_blocks(mcast(sigma_x)),
                sigma_s=self._shard_blocks(mcast(sigma_s)),
            )

        rhs_x = -(
            self._grad_lag_primals(state, jac_eq, jac_ineq, grad_f, jtlam)
            + base.barrier_grad_term(
                x, bounds.xl["blocks"], bounds.xu["blocks"], barrier
            )
        )
        rhs_s = -(
            -state.duals_ineq
            + base.barrier_grad_term(s, bounds.gl, bounds.gu, barrier)
        )
        rhs_yeq = -c_eq
        rhs_yineq = -(c_ineq - s)
        rhs_lam = -self._link_resid(x, c)
        rhs_blocks = jnp.concatenate(
            [rhs_x, rhs_s, rhs_yeq, rhs_yineq, rhs_lam], axis=1
        )
        rhs_coupling = self._scatter_link_duals_to_coupling(state.duals_eq)
        rhs = BlockRhs(blocks=self._shard_blocks(rhs_blocks), coupling=rhs_coupling)
        return data, rhs

    def assemble_kkt(self, data_and_rhs, w_reg, c_reg) -> LocalBlockKKT:
        return self._assemble_kkt(
            data_and_rhs[0], jnp.asarray(w_reg), jnp.asarray(c_reg)
        )

    def _assemble_kkt_impl(self, data, w_reg, c_reg):
        if self.block_form == "banded":
            from parapint_tpu.linalg.banded_schur import BandedLocalBlockKKT

            dt = data.dtype
            # w_reg ADDS to real x-var diagonals; c_reg SETs real
            # constraint diagonals (zero in the probed baseline) — the
            # banded image of assemble_block_diag's semantics
            bands = data.at[:, 0, :].add(
                jnp.asarray(w_reg, dtype=dt) * self._b_w_mask.astype(dt)
                - jnp.asarray(c_reg, dtype=dt) * self._b_c_mask.astype(dt)
            )
            q = jnp.asarray(c_reg, dtype=dt) * jnp.eye(self.ncv, dtype=dt)
            return BandedLocalBlockKKT(
                sym_bands=self._shard_blocks(bands),
                border_loc=self._shard_blocks(self._border_loc_perm.astype(dt)),
                row_idx=self._shard_blocks(self.row_idx),
                q=q,
                mask=jnp.ones(self.N, dtype=dt),
                perm=self._b_perm,
                iperm=self._b_iperm,
                assembly=self.sc_assembly,
            )
        diag = assemble_block_diag(
            data,
            self.eq_mask,
            self.ineq_mask,
            self.x_mask,
            self.link_rows,
            self.link_mask,
            w_reg,
            c_reg,
        )
        # coupling variables are primal: Q = +c_reg * I under regularization
        # (the reference *sets* the coupling-var diagonal to the hessian-reg
        # coefficient, sc_ip_interface.py:925-933; both coefficients share
        # the same value in numeric_factorization, interior_point.py:385-386)
        q = jnp.asarray(c_reg, dtype=diag.dtype) * jnp.eye(
            self.ncv, dtype=diag.dtype
        )
        return LocalBlockKKT.make(
            diag=self._shard_blocks(diag),
            border_loc=self._shard_blocks(self.border_loc),
            row_idx=self._shard_blocks(self.row_idx),
            q=q,
            assembly=self.sc_assembly,
        )

    def kkt_rhs(self, data_and_rhs) -> BlockRhs:
        return data_and_rhs[1]

    # -- delta extraction ----------------------------------------------------

    def extract_deltas(self, state, sol: BlockRhs, barrier) -> IPState:
        return self._extract_deltas(state, self.bounds, sol, barrier)

    def _extract_deltas_impl(self, state, bounds, sol, barrier):
        n, me, mi = self.n, self.me, self.mi
        blocks = sol.blocks
        dx = blocks[:, self.off_x : self.off_x + n]
        ds = blocks[:, self.off_s : self.off_s + mi]
        dyeq = blocks[:, self.off_yeq : self.off_yeq + me]
        dyineq = blocks[:, self.off_yineq : self.off_yineq + mi]
        dlam = blocks[:, self.off_lam : self.off_lam + self.n_link] * self.link_mask
        dc = sol.coupling
        dzl = base.delta_duals_lb(
            barrier,
            state.duals_primals_lb["blocks"],
            dx,
            state.primals["blocks"],
            bounds.xl["blocks"],
        )
        dzu = base.delta_duals_ub(
            barrier,
            state.duals_primals_ub["blocks"],
            dx,
            state.primals["blocks"],
            bounds.xu["blocks"],
        )
        dvl = base.delta_duals_lb(
            barrier, state.duals_slacks_lb, ds, state.slacks, bounds.gl
        )
        dvu = base.delta_duals_ub(
            barrier, state.duals_slacks_ub, ds, state.slacks, bounds.gu
        )
        zeros_c = jnp.zeros(self.ncv)
        return IPState(
            primals={"blocks": dx, "coupling": dc},
            slacks=ds,
            duals_eq={"own": dyeq, "link": dlam},
            duals_ineq=dyineq,
            duals_primals_lb={"blocks": dzl, "coupling": zeros_c},
            duals_primals_ub={"blocks": dzu, "coupling": zeros_c},
            duals_slacks_lb=dvl,
            duals_slacks_ub=dvu,
        )

    # -- fraction to the boundary -------------------------------------------

    def fraction_to_the_boundary(self, state, deltas, tau):
        return self._fraction_to_the_boundary(state, deltas, self.bounds, tau)

    def _ftb_impl(self, state, deltas, bounds, tau):
        x = state.primals["blocks"].reshape(-1)
        dx = deltas.primals["blocks"].reshape(-1)
        a_p = jnp.minimum(
            jnp.minimum(
                base.ftb_lb(tau, x, dx, bounds.xl["blocks"].reshape(-1)),
                base.ftb_ub(tau, x, dx, bounds.xu["blocks"].reshape(-1)),
            ),
            jnp.minimum(
                base.ftb_lb(
                    tau,
                    state.slacks.reshape(-1),
                    deltas.slacks.reshape(-1),
                    bounds.gl.reshape(-1),
                ),
                base.ftb_ub(
                    tau,
                    state.slacks.reshape(-1),
                    deltas.slacks.reshape(-1),
                    bounds.gu.reshape(-1),
                ),
            ),
        )
        a_d = jnp.minimum(
            jnp.minimum(
                base.ftb_duals(
                    tau,
                    state.duals_primals_lb["blocks"].reshape(-1),
                    deltas.duals_primals_lb["blocks"].reshape(-1),
                ),
                base.ftb_duals(
                    tau,
                    state.duals_primals_ub["blocks"].reshape(-1),
                    deltas.duals_primals_ub["blocks"].reshape(-1),
                ),
            ),
            jnp.minimum(
                base.ftb_duals(
                    tau,
                    state.duals_slacks_lb.reshape(-1),
                    deltas.duals_slacks_lb.reshape(-1),
                ),
                base.ftb_duals(
                    tau,
                    state.duals_slacks_ub.reshape(-1),
                    deltas.duals_slacks_ub.reshape(-1),
                ),
            ),
        )
        return a_p, a_d

    # -- step update ---------------------------------------------------------

    def apply_step(self, state, deltas, alpha_primal, alpha_dual, alpha=1.0) -> IPState:
        return self._apply_step(state, deltas, alpha_primal, alpha_dual, alpha)

    def _apply_step_impl(self, state, deltas, a_p, a_d, alpha):
        ap = alpha * a_p
        ad = alpha * a_d
        add = lambda coef: (lambda s, d: s + coef * d)
        return IPState(
            primals=jax.tree_util.tree_map(add(ap), state.primals, deltas.primals),
            slacks=state.slacks + ap * deltas.slacks,
            duals_eq=jax.tree_util.tree_map(add(ad), state.duals_eq, deltas.duals_eq),
            duals_ineq=state.duals_ineq + ad * deltas.duals_ineq,
            duals_primals_lb=jax.tree_util.tree_map(
                add(ad), state.duals_primals_lb, deltas.duals_primals_lb
            ),
            duals_primals_ub=jax.tree_util.tree_map(
                add(ad), state.duals_primals_ub, deltas.duals_primals_ub
            ),
            duals_slacks_lb=state.duals_slacks_lb + ad * deltas.duals_slacks_lb,
            duals_slacks_ub=state.duals_slacks_ub + ad * deltas.duals_slacks_ub,
        )
