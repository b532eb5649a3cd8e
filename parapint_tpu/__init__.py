"""parapint_tpu — a JAX structured-NLP interior-point framework.

A from-scratch re-design of the capabilities of sandialabs/parapint
(parallel primal-dual interior-point solution of block-structured NLPs:
dynamic optimization via time-block decomposition and two-stage stochastic
programs via scenario decomposition, with an explicit Schur-complement
decomposition of the block-bordered KKT system) for accelerators, here an
NVIDIA H100:

- Modeling/AD: NLP models are pure JAX functions; gradients, Jacobians and
  the Hessian of the Lagrangian come from ``jax.grad``/``jax.jacfwd``/
  ``jax.hessian`` (replacing the reference's Pyomo/PyNumero/ASL stack,
  /root/reference/parapint/interfaces/interface.py:250).
- Linear algebra: per-block KKT systems are dense, padded to uniform sizes,
  and factorized with a batched blocked LDL^T kernel that reads the inertia
  off D (replacing HSL MA27 / MUMPS, /root/reference/parapint/linalg/).
- Parallelism: blocks are sharded over a ``jax.sharding.Mesh`` axis; the
  Schur complement is reduced with ``psum`` (NCCL between GPUs) and
  factorized redundantly on every device (replacing mpi4py collectives,
  /root/reference/parapint/linalg/schur_complement/mpi_explicit_schur_complement.py).

The interior-point algorithm itself (``ip_solve``) matches the reference's
semantics (barrier update, fraction-to-the-boundary, inertia correction,
convergence scaling; /root/reference/parapint/algorithms/interior_point.py).
"""

import jax as _jax

# The interior-point method genuinely needs double precision near convergence
# (tol=1e-8 per the reference defaults); Hopper runs f64 natively.
# Mixed-precision fast paths live in parapint_tpu.ops.
_jax.config.update("jax_enable_x64", True)

# On Hopper, JAX's default matmul precision lets f32 products run in TF32
# (a 10-bit mantissa, about three decimal digits).  Factorizations are not
# neural-net matmuls: such products destroy pivot signs (inertia) and make
# iterative refinement diverge.  "highest" keeps f32 products in full f32,
# which the whole linalg layer assumes.
_jax.config.update("jax_default_matmul_precision", "highest")

from parapint_tpu.options import (
    IPOptions,
    InertiaCorrectionOptions,
    LinalgOptions,
    LineSearchOptions,
)
from parapint_tpu.linalg import (
    LinearSolverStatus,
    LinearSolverResults,
    LinearSolver,
    DenseLDLSolver,
    DenseLUSolver,
    SchurComplementSolver,
    ShardedSchurComplementSolver,
    PCGSchurComplementSolver,
    BlockTridiagSolver,
    CondensedLSQSolver,
    BandedSchurComplementSolver,
    ShardedBandedSchurComplementSolver,
)
from parapint_tpu.models import NLPModel
from parapint_tpu.interfaces import (
    InteriorPointInterface,
    DynamicSchurComplementInteriorPointInterface,
    StochasticSchurComplementInteriorPointInterface,
    DynamicModelSpec,
    StochasticModelSpec,
)
from parapint_tpu.algorithms import (
    ip_solve,
    ip_solve_fused,
    make_fused_ip_solve,
    InteriorPointStatus,
)

__version__ = "0.1.0"

__all__ = [
    "IPOptions",
    "InertiaCorrectionOptions",
    "LinalgOptions",
    "LineSearchOptions",
    "LinearSolverStatus",
    "LinearSolverResults",
    "LinearSolver",
    "DenseLDLSolver",
    "DenseLUSolver",
    "SchurComplementSolver",
    "ShardedSchurComplementSolver",
    "PCGSchurComplementSolver",
    "BlockTridiagSolver",
    "CondensedLSQSolver",
    "BandedSchurComplementSolver",
    "ShardedBandedSchurComplementSolver",
    "NLPModel",
    "InteriorPointInterface",
    "DynamicSchurComplementInteriorPointInterface",
    "StochasticSchurComplementInteriorPointInterface",
    "DynamicModelSpec",
    "StochasticModelSpec",
    "ip_solve",
    "ip_solve_fused",
    "make_fused_ip_solve",
    "InteriorPointStatus",
]
