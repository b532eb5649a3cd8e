"""Kernel-vs-dense-oracle tests for the LDL^T factorization.

Mirrors the reference's kernel test tier (factor/solve against known
solutions, /root/reference/parapint/linalg/tests/test_linear_solvers.py:63-99)
with numpy as the oracle.
"""

import numpy as np
import jax.numpy as jnp
import jax
import pytest

from parapint_tpu.ops.ldl import (
    batched_ldl_factor,
    batched_ldl_solve,
    ldl_factor,
    ldl_inertia,
    ldl_solve,
)


def random_sym(n, rng, definite=False):
    A = rng.standard_normal((n, n))
    A = 0.5 * (A + A.T)
    if definite:
        A = A @ A.T + n * np.eye(n)
    return A


def kkt_like(n, m, rng, c_reg=0.0):
    H = rng.standard_normal((n, n))
    H = H @ H.T + n * np.eye(n)
    J = rng.standard_normal((m, n))
    return np.block([[H, J.T], [J, -c_reg * np.eye(m)]])


@pytest.mark.parametrize("n,m,bs", [(3, 0, 8), (20, 9, 8), (150, 70, 64), (100, 30, 128)])
def test_factor_solve_vs_numpy(n, m, bs):
    rng = np.random.default_rng(42)
    K = kkt_like(n, m, rng, c_reg=1e-8)
    LD, d = ldl_factor(jnp.asarray(K), block_size=bs)
    x_true = rng.standard_normal(n + m)
    rhs = K @ x_true
    x = np.asarray(ldl_solve(LD, jnp.asarray(rhs)))
    assert np.allclose(x, x_true, rtol=1e-8, atol=1e-8)
    # multi-RHS
    B = rng.standard_normal((n + m, 4))
    X = np.asarray(ldl_solve(LD, jnp.asarray(B)))
    assert np.allclose(K @ X, B, rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("n,m", [(10, 4), (64, 64), (130, 17)])
def test_inertia_vs_eigvalsh(n, m):
    rng = np.random.default_rng(7)
    K = kkt_like(n, m, rng, c_reg=1e-6)
    LD, d = ldl_factor(jnp.asarray(K), block_size=32)
    pos, neg, zero = ldl_inertia(d, n=n + m)
    w = np.linalg.eigvalsh(K)
    assert int(pos) == int((w > 0).sum())
    assert int(neg) == int((w < 0).sum())
    assert int(zero) == 0


def test_singular_detection():
    rng = np.random.default_rng(3)
    A = random_sym(30, rng, definite=True)
    A[:, 5] = 0.0
    A[5, :] = 0.0
    LD, d = ldl_factor(jnp.asarray(A), block_size=16)
    pos, neg, zero = ldl_inertia(d, n=30)
    assert int(pos) + int(neg) < 30  # zero pivot detected


def test_indefinite_diagonal():
    # pure diagonal: inertia must match the sign pattern exactly
    diag = np.array([3.0, -1.0, 2.0, -4.0, 5.0])
    LD, d = ldl_factor(jnp.asarray(np.diag(diag)), block_size=8)
    pos, neg, zero = ldl_inertia(d, n=5)
    assert (int(pos), int(neg), int(zero)) == (3, 2, 0)
    x = np.asarray(ldl_solve(LD, jnp.asarray(np.ones(5))))
    assert np.allclose(x, 1.0 / diag)


def test_batched():
    rng = np.random.default_rng(11)
    Ks = np.stack([kkt_like(40, 15, rng, 1e-8) for _ in range(6)])
    LDs, ds = batched_ldl_factor(jnp.asarray(Ks), 32)
    rhs = rng.standard_normal((6, 55))
    xs = np.asarray(batched_ldl_solve(LDs, jnp.asarray(rhs)))
    for i in range(6):
        assert np.allclose(Ks[i] @ xs[i], rhs[i], rtol=1e-7, atol=1e-7)


def test_refactorization_same_shapes():
    # factor, solve, re-factor a different matrix of identical shape (the IP
    # loop's per-iteration pattern; reference re-runs numeric factorization
    # in test_mpi_explicit_schur_complement.py:113-115)
    rng = np.random.default_rng(19)
    for seed in range(3):
        K = kkt_like(33, 12, np.random.default_rng(seed), 1e-8)
        LD, d = ldl_factor(jnp.asarray(K), block_size=16)
        rhs = rng.standard_normal(45)
        x = np.asarray(ldl_solve(LD, jnp.asarray(rhs)))
        assert np.allclose(K @ x, rhs, rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("n,bs", [(6, 8), (20, 8), (100, 32), (130, 64)])
def test_factor_winv_batched_matches_separate(n, bs):
    """Fused factor + W = L^{-1} path vs the separate factor-then-invert
    pipeline (both packed LD and the global inverse must agree)."""
    from parapint_tpu.ops.ldl import (
        ldl_factor_batched,
        ldl_factor_winv_batched,
        ldl_winv,
    )

    rng = np.random.default_rng(5)
    A = np.stack([kkt_like(n - 2, 2, rng, c_reg=1e-6) for _ in range(4)])
    LD_ref, _ = ldl_factor_batched(jnp.asarray(A), block_size=bs)
    W_ref, d_ref = jax.vmap(ldl_winv)(LD_ref)
    LD, d, W = ldl_factor_winv_batched(jnp.asarray(A), block_size=bs)
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(W), np.asarray(W_ref), rtol=1e-10, atol=1e-10)
    # W really inverts the unit-lower factor: W @ L = I on the padded size
    npad = W.shape[-1]
    L = np.tril(np.asarray(LD), -1) + np.eye(npad)
    prod = np.einsum("bij,bjk->bik", np.asarray(W), L)
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(npad), prod.shape), atol=1e-8)


def test_panel_width_snaps_to_multiple_of_8():
    """Odd block sizes (e.g. the chain SC's ns=49 tiles) snap the panel
    width UP to a multiple of 8 so the slab kernel stays eligible; the
    extra rows are identity padding excluded from the inertia."""
    import jax

    from parapint_tpu.ops.ldl import (
        ldl_factor_batched,
        ldl_factor_winv_batched,
        ldl_inertia,
    )

    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 49, 49))
    A = (A + A.transpose(0, 2, 1)) + 49 * np.eye(49)
    LD, d = ldl_factor_batched(jnp.asarray(A), block_size=64)
    assert LD.shape[-1] == 56, LD.shape
    LD2, d2, W = ldl_factor_winv_batched(jnp.asarray(A), block_size=64)
    assert LD2.shape[-1] == 56
    L = np.tril(np.asarray(LD2), -1) + np.eye(56)
    rec = np.einsum("bij,bj,bkj->bik", L, np.asarray(d2), L)[:, :49, :49]
    assert np.max(np.abs(rec - A)) < 1e-9 * np.max(np.abs(A))
    pos, neg, zero = jax.vmap(lambda x: ldl_inertia(x, n=49))(d2)
    w = np.linalg.eigvalsh(A[0])
    assert int(pos[0]) == (w > 0).sum() and int(neg[0]) == (w < 0).sum()
    assert int(zero[0]) == 0
