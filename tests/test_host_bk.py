"""Native Bunch-Kaufman host solver tests (vs numpy oracle + the MA27-role
contract: pivoted factorization of saddle KKT systems with inertia)."""

import numpy as np
import jax.numpy as jnp
import pytest

try:
    from parapint_tpu.linalg import HostBKSolver
    from parapint_tpu import native

    HAVE_NATIVE = native.available()
except Exception:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="native lib unavailable")


def saddle(n, m, rng, zero_block=True):
    H = rng.standard_normal((n, n))
    H = H @ H.T + 0.1 * np.eye(n)
    J = rng.standard_normal((m, n))
    C = np.zeros((m, m)) if zero_block else -1e-8 * np.eye(m)
    return np.block([[H, J.T], [J, C]])


def test_factor_solve_inertia():
    rng = np.random.default_rng(0)
    solver = HostBKSolver()
    K = saddle(40, 15, rng)  # hard zero (2,2) block: needs pivoting
    fact = solver.numeric(jnp.asarray(K))
    assert int(solver.status(fact)) == 0
    x_true = rng.standard_normal(55)
    x = np.asarray(solver.solve(fact, jnp.asarray(K @ x_true)))
    assert np.allclose(x, x_true, atol=1e-9)
    pos, neg, zero = solver.inertia(fact)
    w = np.linalg.eigvalsh(K)
    assert (int(pos), int(neg), int(zero)) == ((w > 0).sum(), (w < 0).sum(), 0)


def test_multirhs():
    rng = np.random.default_rng(1)
    solver = HostBKSolver()
    K = saddle(20, 8, rng)
    fact = solver.numeric(jnp.asarray(K))
    B = rng.standard_normal((28, 5))
    X = np.asarray(solver.solve(fact, jnp.asarray(B)))
    assert np.allclose(K @ X, B, atol=1e-9)


def test_batched():
    rng = np.random.default_rng(2)
    solver = HostBKSolver()
    Ks = np.stack([saddle(25, 10, rng) for _ in range(8)])
    fact = solver.numeric(jnp.asarray(Ks))
    assert int(solver.status(fact)) == 0
    rhs = rng.standard_normal((8, 35))
    X = np.asarray(solver.solve(fact, jnp.asarray(rhs)))
    for b in range(8):
        assert np.allclose(Ks[b] @ X[b], rhs[b], atol=1e-9)
    pos, neg, zero = solver.inertia(fact)
    assert (int(pos), int(neg), int(zero)) == (8 * 25, 8 * 10, 0)


def test_oracle_for_unpivoted_kernel():
    """Cross-check the device LDL kernel against the pivoted host factorization
    on a well-conditioned quasi-definite system (where both must agree)."""
    from parapint_tpu.ops.ldl import ldl_factor, ldl_solve

    rng = np.random.default_rng(3)
    K = saddle(30, 12, rng, zero_block=False)
    K[30:, 30:] -= np.eye(12)  # strongly quasi-definite
    solver = HostBKSolver()
    fact = solver.numeric(jnp.asarray(K))
    b = rng.standard_normal(42)
    x_host = np.asarray(solver.solve(fact, jnp.asarray(b)))
    LD, d = ldl_factor(jnp.asarray(K), block_size=16)
    x_dev = np.asarray(ldl_solve(LD, jnp.asarray(b)))
    assert np.allclose(x_host, x_dev, atol=1e-9)


def test_singular_detection():
    solver = HostBKSolver()
    K = np.zeros((5, 5))
    K[0, 0] = 1.0
    fact = solver.numeric(jnp.asarray(K))
    assert int(solver.status(fact)) == 2  # singular


def test_ip_solve_with_host_solver():
    """End-to-end interior point with the native solver (Python loop)."""
    import parapint_tpu as pt

    model = pt.NLPModel(
        objective=lambda v: v[0] ** 2 + v[1] ** 2,
        eq_constraints=lambda v: jnp.array([v[1] - jnp.exp(v[0])]),
        x0=jnp.array([0.5, 0.5]),
    )
    interface = pt.InteriorPointInterface(model)
    options = pt.IPOptions()
    options.linalg.solver = HostBKSolver()
    status = pt.ip_solve(interface, options)
    assert status == pt.InteriorPointStatus.optimal
