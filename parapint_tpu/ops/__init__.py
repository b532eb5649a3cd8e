"""Dense device compute kernels (factorizations, solves)."""

from parapint_tpu.ops.ldl import (
    ldl_factor,
    ldl_solve,
    ldl_inertia,
    batched_ldl_factor,
    batched_ldl_solve,
)

__all__ = [
    "ldl_factor",
    "ldl_solve",
    "ldl_inertia",
    "batched_ldl_factor",
    "batched_ldl_solve",
]
