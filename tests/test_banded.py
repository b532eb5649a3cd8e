"""Banded per-block factorization path (linalg/banded_schur.py +
interfaces banded mode) — the MA27 sparse capability envelope
(/root/reference/parapint/linalg/ma27_interface.py:9-256): per-block
memory O(nk * bandwidth) instead of O(nk^2), validated against the dense
path on the Burgers family
(/root/reference/parapint/examples/burgers.py:14-20, whose --nfe_x scaling
knob makes the dense path infeasible beyond ~100).

Also the triangular-inverse stability regression: a former
Neumann-doubling unit_lower_inv silently lost all digits on matrices whose
nilpotent powers grow before annihilating — e.g. the squared 1D Laplacian
(biharmonic-like operators, exactly what PDE-chain Schur complements look
like).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import parapint_tpu as pt
from parapint_tpu.examples import burgers
from parapint_tpu.linalg.banded_schur import (
    thomas_factor_batched,
    thomas_solve_batched,
)
from parapint_tpu.linalg.schur import BlockRhs
from parapint_tpu.ops.banded import sym_band_to_tridiag_tiles, sym_banded_matvec
from parapint_tpu.ops.ldl import ldl_factor, ldl_solve, unit_lower_inv


def _biharmonic(n):
    """Squared 1D Laplacian + shift: deterministic trigger of the old
    Neumann-doubling instability (||N^64|| ~ 1e17 while ||L^{-1}|| ~ 2)."""
    T = 2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    return T @ T + 0.01 * np.eye(n)


class TestTriangularInverseStability:
    def test_unit_lower_inv_biharmonic(self):
        import scipy.linalg as sla

        n = 128
        K = _biharmonic(n)
        A = K.copy()
        for j in range(n):
            A[j + 1 :, j] /= A[j, j]
            A[j + 1 :, j + 1 :] -= np.outer(A[j + 1 :, j], A[j + 1 :, j]) * A[j, j]
        L = np.tril(A, -1) + np.eye(n)
        Wref = sla.solve_triangular(
            L, np.eye(n), lower=True, unit_diagonal=True
        )
        W = np.asarray(unit_lower_inv(jnp.asarray(L)))
        assert np.abs(W - Wref).max() < 1e-11
        Wb = np.asarray(unit_lower_inv(jnp.asarray(L)[None, ...]))[0]
        assert np.abs(Wb - Wref).max() < 1e-11

    def test_ldl_solve_biharmonic(self):
        # end-to-end: the old instability produced ~1e98 pivots and O(1)
        # solve residuals through the blocked panel solve at block_size 128
        n = 597
        K = _biharmonic(n)
        LD, d = ldl_factor(jnp.asarray(K), block_size=128)
        assert float(jnp.abs(d).max()) < 1e3
        e = jnp.zeros(n).at[0].set(1.0)
        x = ldl_solve(LD, e)
        assert float(jnp.abs(jnp.asarray(K) @ x - e).max()) < 1e-8

    def test_dense_ldl_solver_biharmonic_both_modes(self):
        n = 300
        K = jnp.asarray(_biharmonic(n))
        rhs = jnp.asarray(np.random.default_rng(0).normal(size=n))
        for explicit in (False, True):
            s = pt.DenseLDLSolver(explicit_inverse=explicit, refine_steps=1)
            f = s.numeric(K)
            x = s.solve(f, rhs)
            assert float(jnp.abs(K @ x - rhs).max()) < 1e-8, explicit


class TestThomas:
    def test_factor_solve_inertia_vs_dense(self):
        rng = np.random.default_rng(0)
        N, nk, p, ts = 3, 40, 5, 8
        bands = np.zeros((N, p + 1, nk))
        Ks = []
        for b in range(N):
            A = rng.normal(size=(nk, nk))
            K = (A + A.T) / 2
            K[np.abs(np.subtract.outer(range(nk), range(nk))) > p] = 0.0
            K += np.diag(np.sign(rng.normal(size=nk)) * (5.0 + rng.random(nk)))
            Ks.append(K)
            for e in range(p + 1):
                bands[b, e, : nk - e] = np.diag(K, -e)
        bands = jnp.asarray(bands)
        # matvec
        x = rng.normal(size=(nk, 2))
        mv = np.asarray(sym_banded_matvec(bands[0], jnp.asarray(x)))
        assert np.abs(mv - Ks[0] @ x).max() < 1e-12
        diag_t, upper_t = jax.vmap(
            lambda sb: sym_band_to_tridiag_tiles(sb, ts)
        )(bands)
        fact = thomas_factor_batched(diag_t, upper_t, jnp.ones(N))
        r = rng.normal(size=(N, nk))
        sol = np.asarray(
            thomas_solve_batched(
                fact, jnp.asarray(r).reshape(N, nk // ts, ts)
            ).reshape(N, nk)
        )
        pos = neg = 0
        for b in range(N):
            assert np.abs(sol[b] - np.linalg.solve(Ks[b], r[b])).max() < 1e-10
            w = np.linalg.eigvalsh(Ks[b])
            pos += (w > 0).sum()
            neg += (w < 0).sum()
        assert tuple(np.asarray(fact.inertia)[:2]) == (pos, neg)
        # multi-RHS
        R = rng.normal(size=(N, nk, 4))
        S = np.asarray(
            thomas_solve_batched(
                fact, jnp.asarray(R).reshape(N, nk // ts, ts, 4)
            ).reshape(N, nk, 4)
        )
        for b in range(N):
            assert np.abs(S[b] - np.linalg.solve(Ks[b], R[b])).max() < 1e-10


class TestRound5Primitives:
    """The trace-driven kernels: one-hot permutation (bit-exact
    claim), tile-form block-tridiagonal matvec, and the scatter-free skew
    band->tile construction, each against a dense oracle."""

    def test_permute_cols_bit_exact(self):
        from parapint_tpu.linalg.banded_schur import (
            _permute_cols,
            _permute_cols_inv,
        )

        rng = np.random.default_rng(3)
        nk = 237
        perm = jnp.asarray(rng.permutation(nk), jnp.int32)
        for dtype in (jnp.float32, jnp.float64):
            x = jnp.asarray(
                rng.standard_normal((5, nk)) * 10.0 ** rng.integers(-20, 20, (5, nk))
            ).astype(dtype)
            y = _permute_cols(x, perm)
            assert np.array_equal(
                np.asarray(y), np.asarray(x)[:, np.asarray(perm)]
            ), "forward permutation must be bit-exact for |x| >= ~1e-23"
            x2 = _permute_cols_inv(y, perm)
            assert np.array_equal(np.asarray(x2), np.asarray(x))
        # components under ~1e-23: the lo (then mid) split underflows f32
        # subnormals — relative error <= ~1e-12 down to ~1e-29, absolute
        # < 1e-40 below (see the _permute_cols docstring)
        xm = jnp.asarray(rng.standard_normal((2, nk)) * 1e-27)
        ym = np.asarray(_permute_cols(xm, perm))
        refm = np.asarray(xm)[:, np.asarray(perm)]
        assert (np.abs(ym - refm) / np.abs(refm)).max() < 1e-12
        xt = jnp.asarray(rng.standard_normal((2, nk)) * 1e-32)
        yt = np.asarray(_permute_cols(xt, perm))
        reft = np.asarray(xt)[:, np.asarray(perm)]
        assert np.abs(yt - reft).max() <= np.abs(reft).max() * 2.0**-23

    def test_tile_matvec_vs_dense(self):
        from parapint_tpu.linalg.banded_schur import tridiag_tiles_matvec

        rng = np.random.default_rng(4)
        N, m, ts = 3, 4, 8
        diag_t = rng.standard_normal((N, m, ts, ts))
        diag_t = diag_t + np.swapaxes(diag_t, 2, 3)
        upper_t = rng.standard_normal((N, m - 1, ts, ts))
        x = rng.standard_normal((N, m, ts))
        y = np.asarray(
            tridiag_tiles_matvec(jnp.asarray(diag_t), jnp.asarray(upper_t), jnp.asarray(x))
        )
        for b in range(N):
            K = np.zeros((m * ts, m * ts))
            for g in range(m):
                K[g * ts : (g + 1) * ts, g * ts : (g + 1) * ts] = diag_t[b, g]
            for g in range(m - 1):
                K[g * ts : (g + 1) * ts, (g + 1) * ts : (g + 2) * ts] = upper_t[b, g]
                K[(g + 1) * ts : (g + 2) * ts, g * ts : (g + 1) * ts] = upper_t[b, g].T
            ref = K @ x[b].reshape(-1)
            assert np.abs(y[b].reshape(-1) - ref).max() < 1e-12

    def test_skew_tiling_vs_dense(self):
        rng = np.random.default_rng(5)
        for p, ts, n in ((5, 8, 24), (7, 8, 16), (3, 4, 12)):
            K = rng.standard_normal((n, n))
            K = K + K.T
            K[np.abs(np.subtract.outer(range(n), range(n))) > p] = 0.0
            bands = np.zeros((p + 1, n))
            for e in range(p + 1):
                bands[e, : n - e] = np.diag(K, -e)
            diag_t, upper_t = sym_band_to_tridiag_tiles(jnp.asarray(bands), ts)
            m = n // ts
            R = np.zeros((n, n))
            for g in range(m):
                R[g * ts : (g + 1) * ts, g * ts : (g + 1) * ts] = np.asarray(
                    diag_t[g]
                )
            for g in range(m - 1):
                U = np.asarray(upper_t[g])
                R[g * ts : (g + 1) * ts, (g + 1) * ts : (g + 2) * ts] = U
                R[(g + 1) * ts : (g + 2) * ts, g * ts : (g + 1) * ts] = U.T
            assert np.abs(R - K).max() == 0.0, (p, ts, n)


@pytest.fixture(scope="module")
def small_burgers():
    spec = burgers.build_spec(nfe_x=8, nfe_t=12, num_time_blocks=4)
    iface_d = pt.DynamicSchurComplementInteriorPointInterface(spec)
    iface_b = pt.DynamicSchurComplementInteriorPointInterface(
        spec, block_form="banded"
    )
    return spec, iface_d, iface_b


class TestBandedInterface:
    def test_probe_matches_dense_assembly(self, small_burgers):
        _, iface_d, iface_b = small_burgers
        state = iface_d.init_state()
        data_d = iface_d.eval_kkt_data(state, 0.1)
        kkt_d = iface_d.assemble_kkt(data_d, 0.017, 0.003)
        data_b = iface_b.eval_kkt_data(iface_b.init_state(), 0.1)
        kkt_b = iface_b.assemble_kkt(data_b, 0.017, 0.003)
        # rhs identical
        rd, rb = iface_d.kkt_rhs(data_d), iface_b.kkt_rhs(data_b)
        assert float(jnp.abs(rd.blocks - rb.blocks).max()) < 1e-12
        assert float(jnp.abs(rd.coupling - rb.coupling).max()) < 1e-12
        # bands == permuted dense diag, and the claimed bandwidth holds
        plan = iface_b.banded_plan
        perm = np.asarray(plan.perm)
        D = np.asarray(kkt_d.diag)
        bands = np.asarray(kkt_b.sym_bands)
        nk = iface_d.nk
        for b in range(iface_d.N):
            Kp = D[b][np.ix_(perm, perm)]
            for e in range(plan.p + 1, nk):
                od = np.diag(Kp, -e)
                assert (
                    np.abs(od).max() == 0.0
                ), f"bandwidth violation block {b} band {e}"
            for e in range(plan.p + 1):
                assert (
                    np.abs(bands[b, e, : nk - e] - np.diag(Kp, -e)).max()
                    < 1e-12
                )
        # border strips are the permuted dense ones
        assert (
            np.abs(
                np.asarray(kkt_b.border_loc)
                - np.asarray(kkt_d.border_loc)[:, :, perm]
            ).max()
            == 0.0
        )

    def test_solver_parity_with_dense(self, small_burgers):
        _, iface_d, iface_b = small_burgers
        state = iface_d.init_state()
        data_d = iface_d.eval_kkt_data(state, 0.1)
        kkt_d = iface_d.assemble_kkt(data_d, 0.0, 0.0)
        rhs = iface_d.kkt_rhs(data_d)
        data_b = iface_b.eval_kkt_data(iface_b.init_state(), 0.1)
        kkt_b = iface_b.assemble_kkt(data_b, 0.0, 0.0)

        sol_d = pt.SchurComplementSolver(explicit_inverse=True)
        fd = sol_d.numeric(kkt_d)
        xd, std = sol_d.solve_with_status(fd, rhs)
        for sc_solver in (None, pt.BlockTridiagSolver(ns=iface_b.ns)):
            sol_b = pt.BandedSchurComplementSolver(
                schur_complement_solver=sc_solver
            )
            fb = sol_b.numeric(kkt_b)
            xb, stb = sol_b.solve_with_status(fb, rhs)
            assert int(stb) == int(std) == 0
            assert sol_b.inertia(fb) == sol_d.inertia(fd)
            assert float(jnp.abs(xd.blocks - xb.blocks).max()) < 1e-9
            assert float(jnp.abs(xd.coupling - xb.coupling).max()) < 1e-9

    def test_ip_objective_parity(self, small_burgers):
        spec, iface_d, _ = small_burgers
        opts = pt.IPOptions()
        opts.linalg.solver = pt.SchurComplementSolver(explicit_inverse=True)
        res_d = pt.ip_solve(iface_d, opts)
        assert res_d == pt.InteriorPointStatus.optimal
        obj_d = float(iface_d.evaluate_objective())

        iface_b = pt.DynamicSchurComplementInteriorPointInterface(
            spec, block_form="banded"
        )
        opts_b = pt.IPOptions()
        opts_b.linalg.solver = pt.BandedSchurComplementSolver(
            schur_complement_solver=pt.BlockTridiagSolver(ns=iface_b.ns)
        )
        res_b = pt.ip_solve(iface_b, opts_b)
        assert res_b == pt.InteriorPointStatus.optimal
        obj_b = float(iface_b.evaluate_objective())
        assert abs(obj_d - obj_b) < 1e-9

    def test_fused_ip_parity(self, small_burgers):
        spec, iface_d, _ = small_burgers
        iface_b = pt.DynamicSchurComplementInteriorPointInterface(
            spec, block_form="banded"
        )
        opts_b = pt.IPOptions()
        opts_b.linalg.solver = pt.BandedSchurComplementSolver(
            schur_complement_solver=pt.BlockTridiagSolver(ns=iface_b.ns)
        )
        fused = pt.make_fused_ip_solve(iface_b, opts_b)
        r = fused(iface_b.init_state())
        assert int(r.status) == 0
        iface_b._current_state = r.state
        assert abs(float(iface_b.evaluate_objective()) - 0.05616177379896992) < 1e-8

    def test_bandwidth_saturates_in_nfe_x(self):
        """The capability claim: per-block bandwidth saturates (~72 for the
        Burgers family; measured 72 at nfe_x = 48, 64, 100 and 60 at 200)
        while nk grows linearly in nfe_x — per-block memory is
        O(nk * const) where the dense path is O(nk^2)."""
        spec = burgers.build_spec(nfe_x=64, nfe_t=12, num_time_blocks=4)
        iface = pt.DynamicSchurComplementInteriorPointInterface(
            spec, block_form="banded"
        )
        p, nk = iface.banded_plan.p, iface.nk
        assert p <= 80 and nk >= 900
        assert (p + 1) / nk < 0.09  # >= 11x memory ratio, growing with nfe_x


class TestShardedBanded:
    """Sharded (multi-device) banded path: the MA27 envelope combined with the
    MPI Schur-complement decomposition (reference
    mpi_explicit_schur_complement.py:128-452) — block-Thomas per shard,
    psum-reduced SC, replicated coupling factor."""

    def _mesh(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from jax.sharding import Mesh

        return Mesh(np.array(jax.devices()[:8]), ("blocks",))

    def test_numeric_solve_parity_with_serial(self):
        mesh = self._mesh()
        spec = burgers.build_spec(nfe_x=8, nfe_t=16, num_time_blocks=8)
        iface = pt.DynamicSchurComplementInteriorPointInterface(
            spec, mesh=mesh, block_form="banded"
        )
        data = iface.eval_kkt_data(iface.init_state(), 0.1)
        kkt = iface.assemble_kkt(data, 0.0, 0.0)
        rhs = iface.kkt_rhs(data)

        serial = pt.BandedSchurComplementSolver()
        fs = serial.numeric(kkt)
        xs, sts = serial.solve_with_status(fs, rhs)

        sh = pt.ShardedBandedSchurComplementSolver(mesh)
        fh = jax.jit(sh.numeric)(kkt)
        xh, sth = sh.solve_with_status(fh, rhs)

        assert int(sts) == int(sth) == 0
        assert sh.inertia(fh) == serial.inertia(fs)
        assert float(jnp.abs(xs.blocks - xh.blocks).max()) < 1e-11
        assert float(jnp.abs(xs.coupling - xh.coupling).max()) < 1e-11

    def test_fused_ip_parity_cr_coupling(self):
        """Full fused IP solve, sharded banded blocks + cyclic-reduction
        coupling solver, objective parity vs the serial dense path."""
        mesh = self._mesh()
        spec = burgers.build_spec(nfe_x=8, nfe_t=16, num_time_blocks=8)
        iface = pt.DynamicSchurComplementInteriorPointInterface(
            spec, mesh=mesh, block_form="banded"
        )
        opts = pt.IPOptions()
        opts.linalg.solver = pt.ShardedBandedSchurComplementSolver(
            mesh, schur_complement_solver=pt.BlockTridiagSolver(ns=iface.ns)
        )
        r = pt.make_fused_ip_solve(iface, opts)(iface.init_state())
        assert int(r.status) == 0
        iface._current_state = r.state
        obj = float(iface.evaluate_objective())

        iface_d = burgers.main(nfe_x=8, nfe_t=16, num_time_blocks=8)
        assert abs(obj - float(iface_d.evaluate_objective())) < 1e-8

    def test_fused_ip_nondivisible_blocks(self):
        """11 blocks on 8 shards: pad_banded_block_count masks identity
        blocks and corrects the inertia; chain assembly falls back to
        scatter exactly like the dense sharded path."""
        mesh = self._mesh()
        spec = burgers.build_spec(nfe_x=8, nfe_t=22, num_time_blocks=11)
        iface = pt.DynamicSchurComplementInteriorPointInterface(
            spec, mesh=mesh, block_form="banded"
        )
        opts = pt.IPOptions()
        opts.linalg.solver = pt.ShardedBandedSchurComplementSolver(mesh)
        r = pt.make_fused_ip_solve(iface, opts)(iface.init_state())
        assert int(r.status) == 0
        iface._current_state = r.state
        obj = float(iface.evaluate_objective())

        iface_d = burgers.main(nfe_x=8, nfe_t=22, num_time_blocks=11)
        assert abs(obj - float(iface_d.evaluate_objective())) < 1e-8


@pytest.mark.slow
def test_banded_large_nfe_x_ip():
    """Burgers at nfe_x where dense blocks are 70x the banded memory; the
    objective has no reference value at this size, so assert convergence +
    the KKT residuals the IP certifies."""
    iface = burgers.main(
        nfe_x=96, nfe_t=12, num_time_blocks=4, block_form="banded"
    )
    obj = float(iface.evaluate_objective())
    assert np.isfinite(obj) and obj > 0
