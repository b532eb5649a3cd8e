"""Explicit-inverse (matmul-only) solver mode vs the packed-factor mode.

The production path computes K^{-1} = L^{-T} D^{-1} L^{-1} with
matmuls only (recursive-halving triangular inversion) and recovers
direct-solve accuracy with iterative refinement; results must match the
triangular-solve path to tight tolerance on every solver.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import parapint_tpu as pt
from parapint_tpu.ops.ldl import ldl_factor, ldl_inverse, unit_lower_inv
from test_schur import make_system, dense_assemble  # noqa: F401


def test_unit_lower_inv():
    rng = np.random.default_rng(0)
    for n in (4, 17, 64, 200):
        # note: unit triangulars with O(1) random entries have exponentially
        # ill-conditioned inverses; scale like a realistic Cholesky factor
        L = np.tril(rng.standard_normal((n, n)), -1) / np.sqrt(n) + np.eye(n)
        W = np.asarray(unit_lower_inv(jnp.asarray(L)))
        err = np.abs(W @ L - np.eye(n)).max()
        cond = np.linalg.cond(L)
        assert err < 1e-12 * max(cond, 1.0), (n, err, cond)


def test_ldl_inverse():
    rng = np.random.default_rng(1)
    n, m = 50, 20
    H = rng.standard_normal((n, n))
    H = H @ H.T + n * np.eye(n)
    J = rng.standard_normal((m, n))
    K = np.block([[H, J.T], [J, -1e-8 * np.eye(m)]])
    LD, d = ldl_factor(jnp.asarray(K), block_size=32)
    Kinv = np.asarray(ldl_inverse(LD, d))[: n + m, : n + m]
    assert np.allclose(Kinv @ K, np.eye(n + m), atol=1e-7)


def test_dense_solver_inverse_mode():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((60, 60))
    A = A + A.T + 30 * np.eye(60)
    solver = pt.DenseLDLSolver(block_size=32, explicit_inverse=True)
    fact = solver.numeric(jnp.asarray(A))
    b = rng.standard_normal(60)
    x = np.asarray(solver.solve(fact, jnp.asarray(b)))
    assert np.allclose(A @ x, b, rtol=1e-10, atol=1e-10)
    # multi-RHS
    B = rng.standard_normal((60, 7))
    X = np.asarray(solver.solve(fact, jnp.asarray(B)))
    assert np.allclose(A @ X, B, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("sharded", [False, True])
def test_schur_inverse_mode_matches(sharded):
    if sharded and len(jax.devices()) < 4:
        pytest.skip("needs devices")
    from parapint_tpu.linalg import BlockKKT, SchurComplementSolver
    from parapint_tpu.linalg.schur import BlockRhs

    N, nk, nc = 4, 24, 6
    diag, border, q = make_system(N, nk, nc, seed=5)
    M = dense_assemble(diag, border, q)
    rng = np.random.default_rng(7)
    x_true = rng.standard_normal(M.shape[0])
    rhs = M @ x_true
    kkt = BlockKKT.make(jnp.asarray(diag), jnp.asarray(border), jnp.asarray(q))
    rhs_b = BlockRhs(
        blocks=jnp.asarray(rhs[: N * nk].reshape(N, nk)),
        coupling=jnp.asarray(rhs[N * nk :]),
    )
    if sharded:
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices()[:4]), ("blocks",))
        solver = pt.ShardedSchurComplementSolver(
            mesh, "blocks", block_size=16, explicit_inverse=True
        )
    else:
        solver = SchurComplementSolver(block_size=16, explicit_inverse=True)
    fact = solver.numeric(kkt)
    sol = solver.solve(fact, rhs_b)
    got = np.concatenate([np.asarray(sol.blocks).reshape(-1), np.asarray(sol.coupling)])
    assert np.allclose(got, x_true, rtol=1e-9, atol=1e-9)
    pos, neg, zero = solver.inertia(fact)
    w = np.linalg.eigvalsh(M)
    assert (int(pos), int(neg), int(zero)) == ((w > 0).sum(), (w < 0).sum(), 0)


def test_ip_solve_with_inverse_mode():
    model = pt.NLPModel(
        objective=lambda v: v[0] ** 2 + v[1] ** 2,
        eq_constraints=lambda v: jnp.array([v[1] - jnp.exp(v[0])]),
        ineq_constraints=lambda v: jnp.array([(v[0] - 1.0) ** 2 - v[1]]),
        gu=jnp.array([0.0]),
        x0=jnp.array([0.0, 0.0]),
    )
    interface = pt.InteriorPointInterface(model)
    options = pt.IPOptions()
    options.linalg.solver = pt.DenseLDLSolver(block_size=8, explicit_inverse=True)
    status = pt.ip_solve(interface, options)
    assert status == pt.InteriorPointStatus.optimal
    x = np.asarray(interface.get_primals())
    assert np.allclose(x, [0.0, 1.0], atol=1e-7)


def test_fused_burgers_inverse_mode():
    from parapint_tpu.examples import burgers

    interface = burgers.main(
        nfe_x=8,
        nfe_t=8,
        num_time_blocks=4,
        linear_solver=pt.SchurComplementSolver(block_size=32, explicit_inverse=True),
    )
    obj_inv = float(interface.evaluate_objective())
    interface2 = burgers.main(nfe_x=8, nfe_t=8, num_time_blocks=4)
    obj_ref = float(interface2.evaluate_objective())
    assert np.isclose(obj_inv, obj_ref, rtol=1e-10)
