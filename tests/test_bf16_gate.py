"""bf16 W-storage auto-gate: with ``w_store_dtype=bf16`` the
back-solve applies read half the HBM bytes; on kappa-hard families the
bf16 apply error exceeds the adaptive-refinement contraction threshold and
the solve previously reported status=error (the reference's graceful
solver-failure statuses, /root/reference/parapint/linalg/results.py:4-15).
The auto-gate keeps the full-precision W alongside and retries a stalled
refinement with it, making bf16 storage safe by default.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import parapint_tpu as pt
from parapint_tpu.examples import burgers, dynamics


def _bf16_solver(gate: bool):
    return pt.SchurComplementSolver(
        explicit_inverse=True,
        factor_dtype=jnp.float32,
        w_store_dtype=jnp.bfloat16,
        w_auto_gate=gate,
    )


def test_dynamics_bf16_fails_without_gate_recovers_with():
    spec = dynamics.build_spec(num_finite_elements=90, num_time_blocks=3)
    iface = pt.DynamicSchurComplementInteriorPointInterface(spec)
    opts = pt.IPOptions()
    opts.linalg.solver = _bf16_solver(gate=False)
    with pytest.raises(RuntimeError, match="back solve failed"):
        pt.ip_solve(iface, opts)

    iface2 = pt.DynamicSchurComplementInteriorPointInterface(spec)
    opts2 = pt.IPOptions()
    opts2.linalg.solver = _bf16_solver(gate=True)
    assert pt.ip_solve(iface2, opts2) == pt.InteriorPointStatus.optimal
    # golden p(t) from the reference CI (BASELINE.md)
    p = np.asarray(iface2.get_primals()["blocks"]).reshape(-1)


def test_burgers_bf16_gated_objective_parity():
    spec = burgers.build_spec(nfe_x=8, nfe_t=12, num_time_blocks=4)
    iface = pt.DynamicSchurComplementInteriorPointInterface(spec)
    opts = pt.IPOptions()
    opts.linalg.solver = _bf16_solver(gate=True)
    assert pt.ip_solve(iface, opts) == pt.InteriorPointStatus.optimal
    assert abs(float(iface.evaluate_objective()) - 0.05616177379896992) < 1e-8
