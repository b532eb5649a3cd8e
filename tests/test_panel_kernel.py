"""Triton panel LDL^T kernel (ops/pallas_ldl.py) and its dispatch.

The kernel runs here in Pallas interpret mode; the `gpu`-marked test runs
it compiled on the card (``python chip_smoke.py`` covers the same checks
at the production widths and batches).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parapint_tpu.ops import ldl, pallas_ldl
from parapint_tpu.ops.ldl import _ldl_unblocked


def _quasi_definite(rng, B, b):
    """KKT-like panels: SPD block, then a negative definite block."""
    k = b // 2
    G = rng.standard_normal((B, k, k))
    H = rng.standard_normal((B, b - k, b - k))
    A = np.zeros((B, b, b))
    A[:, :k, :k] = G @ G.transpose(0, 2, 1) / k + np.eye(k)
    A[:, k:, k:] = -(H @ H.transpose(0, 2, 1) / max(1, b - k) + np.eye(b - k))
    C = 0.5 * rng.standard_normal((B, b - k, k))
    A[:, k:, :k] = C
    A[:, :k, k:] = C.transpose(0, 2, 1)
    return A


def _kernel(A, **kw):
    return pallas_ldl.ldl_panels(A, interpret=True, **kw)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("b", [8, 56, 64, 128])
def test_packed_factor_matches_reference(b, dtype):
    """Same packed contract as _ldl_unblocked (strict lower = L, diagonal
    = D), including widths padded up to a power of two (56 -> 64)."""
    rng = np.random.default_rng(b)
    A = jnp.asarray(_quasi_definite(rng, 3, b), dtype)
    F = np.asarray(_kernel(A))
    R = np.asarray(jax.vmap(_ldl_unblocked)(A))
    assert F.shape == (3, b, b)
    tol = 1e-5 if dtype == jnp.float32 else 1e-13
    scale = np.max(np.abs(np.tril(R)))
    assert np.max(np.abs(np.tril(F) - np.tril(R))) <= tol * scale


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("b", [16, 56])
def test_w_output_inverts_l(b, dtype):
    """with_w=True also returns W = L^{-1} of the same factor."""
    rng = np.random.default_rng(100 + b)
    A = jnp.asarray(_quasi_definite(rng, 4, b), dtype)
    F, W = _kernel(A, with_w=True)
    np.testing.assert_array_equal(np.tril(np.asarray(F)), np.tril(np.asarray(_kernel(A))))
    L = np.tril(np.asarray(F, np.float64), -1) + np.eye(b)
    err = np.max(np.abs(np.einsum("nij,njk->nik", L, np.asarray(W, np.float64)) - np.eye(b)))
    assert err < (1e-5 if dtype == jnp.float32 else 1e-13), err


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_inertia_matches_f64_reference(dtype):
    """Pivot signs (the inertia the IP loop corrects on) equal those of
    the f64 reference and the eigenvalue count."""
    rng = np.random.default_rng(7)
    A = _quasi_definite(rng, 6, 48)
    d = np.diagonal(np.asarray(_kernel(jnp.asarray(A, dtype))), axis1=1, axis2=2)
    R = np.asarray(jax.vmap(_ldl_unblocked)(jnp.asarray(A)))
    d_ref = np.diagonal(R, axis1=1, axis2=2)
    np.testing.assert_array_equal(np.sign(d), np.sign(d_ref))
    w = np.linalg.eigvalsh(A)
    assert ((d > 0).sum(axis=1) == (w > 0).sum(axis=1)).all()


@pytest.mark.parametrize("B", [1, 5])
def test_any_batch_size(B):
    """One program per panel: batches of any size, no batch padding."""
    rng = np.random.default_rng(B)
    A = jnp.asarray(_quasi_definite(rng, B, 24))
    F = _kernel(A)
    assert F.shape == (B, 24, 24)
    R = jax.vmap(_ldl_unblocked)(A)
    np.testing.assert_allclose(np.tril(np.asarray(F)), np.tril(np.asarray(R)), atol=1e-12)


def test_factor_reads_pivot_columns_only():
    """The factor derives from the lower triangle: on ulp-asymmetric input
    (any Ruiz-scaled KKT block) it must match the reference, which reads
    the pivot COLUMN.  Reading pivot rows instead once cost ~2x IP
    iterations while every unit tolerance still held."""
    rng = np.random.default_rng(8)
    A = _quasi_definite(rng, 4, 32)
    A = (A + 1e-6 * rng.standard_normal(A.shape)).astype(np.float32)
    F = np.asarray(_kernel(jnp.asarray(A)))
    R = np.asarray(jax.vmap(_ldl_unblocked)(jnp.asarray(A)))
    np.testing.assert_allclose(np.tril(F), np.tril(R), rtol=1e-6, atol=1e-6)
    # garbage in the strict upper triangle changes nothing
    garbage = np.triu(rng.standard_normal(A.shape), 1).astype(np.float32)
    Fg = np.asarray(_kernel(jnp.asarray(np.tril(A) + garbage)))
    np.testing.assert_array_equal(np.tril(Fg), np.tril(F))


@pytest.mark.parametrize(
    "backend,b,dtype,expected",
    [
        ("gpu", 64, jnp.float32, True),
        ("gpu", 128, jnp.float32, True),
        ("gpu", 64, jnp.float64, True),
        ("gpu", 49, jnp.float64, True),  # padded to 64
        ("gpu", 128, jnp.float64, False),  # f64 wider than 64: XLA was faster
        ("gpu", 49, jnp.float32, True),
        ("gpu", 256, jnp.float32, False),  # wider than one program's tile
        ("gpu", 64, jnp.bfloat16, False),
        ("cpu", 64, jnp.float32, False),
    ],
)
def test_dispatch_rule(monkeypatch, backend, b, dtype, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert pallas_ldl.use_kernel(b, dtype) is expected


@pytest.mark.parametrize(
    "b,dtype,w_calls",
    [
        (16, jnp.float32, [False, True]),
        (64, jnp.float64, [False, True]),
        # 128 wide: factor-only kernel, W by triangular solve
        (128, jnp.float32, [False, False]),
    ],
)
def test_panel_step_takes_kernel_when_dispatched(monkeypatch, b, dtype, w_calls):
    """When the rule says kernel, both panel entry points call it (factor
    only, and factor + W where W comes from the kernel) and W inverts L."""
    calls = []
    real = pallas_ldl.ldl_panels

    def fake(A, with_w=False, **kw):
        calls.append(with_w)
        return real(A, with_w=with_w, interpret=True)

    monkeypatch.setattr(pallas_ldl, "use_kernel", lambda b, dt: True)
    monkeypatch.setattr(pallas_ldl, "ldl_panels", fake)
    A = jnp.asarray(_quasi_definite(np.random.default_rng(3), 2, b), dtype)
    ldl._panel_factor_batch(A)
    F, W = ldl._panel_factor_batch_winv(A)
    assert calls == w_calls
    L = np.tril(np.asarray(F, np.float64), -1) + np.eye(b)
    err = np.max(np.abs(np.einsum("nij,njk->nik", L, np.asarray(W, np.float64)) - np.eye(b)))
    assert err < (1e-4 if dtype == jnp.float32 else 1e-12), err


@pytest.mark.parametrize(
    "backend,b,dtype",
    [("cpu", 16, jnp.float64), ("gpu", 128, jnp.float64)],
)
def test_xla_panel_step_when_not_dispatched(monkeypatch, backend, b, dtype):
    """Where the rule says XLA (the CPU backend; f64 wider than 64 on the
    GPU) the kernel is never called, and W from the triangular solve
    inverts L."""

    def boom(*a, **k):
        raise AssertionError("kernel called outside its dispatch rule")

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(pallas_ldl, "ldl_panels", boom)
    A = jnp.asarray(_quasi_definite(np.random.default_rng(4), 2, b), dtype)
    F, W = ldl._panel_factor_batch_winv(A)
    R = jax.vmap(_ldl_unblocked)(A)
    np.testing.assert_allclose(np.tril(np.asarray(F)), np.tril(np.asarray(R)), atol=1e-12)
    L = np.tril(np.asarray(F, np.float64), -1) + np.eye(b)
    err = np.max(np.abs(np.einsum("nij,njk->nik", L, np.asarray(W, np.float64)) - np.eye(b)))
    assert err < 1e-12, err


def _kernel_everywhere(monkeypatch):
    monkeypatch.setattr(pallas_ldl, "use_kernel", pallas_ldl.supported)
    monkeypatch.setattr(
        pallas_ldl,
        "ldl_panels",
        functools.partial(pallas_ldl.ldl_panels, interpret=True),
    )


def test_end_to_end_ip_solve_with_interpret_kernel(monkeypatch):
    """Full fused IP solve (dense explicit-inverse path) with every panel
    step on the kernel in interpret mode: kernel-numerics regressions that
    show only in composition (e.g. a pivot-row read) fail here."""
    _kernel_everywhere(monkeypatch)
    import parapint_tpu as pt
    from parapint_tpu.examples import burgers

    spec = burgers.build_spec(nfe_x=10, nfe_t=16, num_time_blocks=4)
    iface = pt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=jnp.float32
    )
    opts = pt.IPOptions()
    opts.tol = 1e-8
    opts.linalg.solver = pt.SchurComplementSolver(
        block_size=128,
        explicit_inverse=True,
        factor_dtype=jnp.float32,
        refine_steps=0,
        schur_complement_solver=pt.BlockTridiagSolver(),
    )
    solve = pt.make_fused_ip_solve(iface, opts)
    iface.set_bounds_relaxation_factor(opts.bounds_relaxation_factor)
    res = solve(iface.init_state())
    assert int(res.status) == pt.InteriorPointStatus.optimal.value
    # the pivot-row regression showed up as ~2x this count
    assert int(res.iterations) <= 9, int(res.iterations)


def test_end_to_end_banded_solve_with_interpret_kernel(monkeypatch):
    """The flagship's banded block-Thomas path with the kernel in interpret
    mode reaches the same objective as the dense f64 solve."""
    _kernel_everywhere(monkeypatch)
    import parapint_tpu as pt
    from parapint_tpu.examples import burgers

    def solve(iface, solver):
        opts = pt.IPOptions()
        opts.tol = 1e-8
        opts.linalg.solver = solver
        status, res = pt.ip_solve_fused(iface, opts)
        assert status == pt.InteriorPointStatus.optimal
        return float(iface.evaluate_objective())

    spec = burgers.build_spec(nfe_x=10, nfe_t=16, num_time_blocks=4)
    iface = pt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=jnp.float32, block_form="banded"
    )
    obj = solve(
        iface,
        pt.BandedSchurComplementSolver(
            schur_complement_solver=pt.BlockTridiagSolver(ns=iface.ns),
            tile_size=64,
            tile_block_size=32,
        ),
    )
    ref_if = pt.DynamicSchurComplementInteriorPointInterface(spec)
    ref = solve(ref_if, pt.SchurComplementSolver(block_size=32))
    assert abs(obj - ref) <= 1e-6 * max(1.0, abs(ref))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_compiled_kernel_on_gpu(gpu, dtype):
    """The compiled Triton kernel at the flagship's widths vs the f64
    reference on the card."""
    rng = np.random.default_rng(0)
    for b in (64, 128):
        A = jnp.asarray(_quasi_definite(rng, 64, b), dtype)
        F, W = pallas_ldl.ldl_panels(A, with_w=True)
        R = jax.vmap(_ldl_unblocked)(A.astype(jnp.float64))
        d = np.diagonal(np.asarray(F, np.float64), axis1=1, axis2=2)
        d_ref = np.diagonal(np.asarray(R), axis1=1, axis2=2)
        np.testing.assert_array_equal(np.sign(d), np.sign(d_ref))
        L = np.tril(np.asarray(F, np.float64), -1) + np.eye(b)
        rec = np.einsum("nij,nj,nkj->nik", L, d, L)
        A64 = np.asarray(A, np.float64)
        tol = 1e-5 if dtype == jnp.float32 else 1e-12
        assert np.max(np.abs(rec - A64)) <= tol * np.max(np.abs(A64))
