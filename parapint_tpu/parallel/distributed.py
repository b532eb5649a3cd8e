"""Multi-process (multi-host) execution.

The reference proves its communication layer under real multi-process MPI
(`mpirun -np {2,3,4}` oversubscribed on one CI node,
/root/reference/.github/workflows/main_ci.yml:33-41).  The JAX
analogue is JAX's multi-controller runtime: every process calls
:func:`initialize` (a ``jax.distributed.initialize`` wrapper), after which
``jax.devices()`` spans ALL processes and a :func:`global_mesh` built over
it makes ``shard_map`` collectives run across process boundaries (NCCL
between GPUs, TCP on CPU test runs) — the same solver code, unchanged.

Launching (the ``mpirun`` analogue):

    # process 0                                # process 1
    python prog.py --process-id 0 ...          python prog.py --process-id 1 ...

with each process calling::

    from parapint_tpu.parallel import distributed
    distributed.initialize("host0:1234", num_processes=2, process_id=<i>)
    mesh = distributed.global_mesh("blocks")

On a managed cluster, ``initialize()`` with no arguments picks up the
cluster environment; elsewhere pass the coordinator address, process
count and process id.  For CPU-based testing, set
``local_device_count`` to emulate several devices per process — the
2-process test in tests/test_multiprocess.py is this package's equivalent
of the reference's mpirun CI job.

Host-replicated data (every process builds the same numpy arrays, as the
deterministic interfaces here do) is placed onto a global mesh with
:func:`replicated_to_global`.
"""

from typing import Optional

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
) -> None:
    """Start the multi-controller runtime (call once per process, before
    any other JAX operation).

    Parameters mirror ``jax.distributed.initialize``; all-None auto-detects
    the cluster environment (managed clusters).  ``local_device_count`` forces the
    number of local (CPU) devices — test/CI use.
    """
    import jax

    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", local_device_count)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis_name: str = "blocks"):
    """1-D mesh over ALL devices of ALL processes."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis_name,))


def replicated_to_global(mesh, spec, tree):
    """Place host-replicated (identical on every process) numpy/jax arrays
    onto a global mesh with the given PartitionSpec pytree (a single spec
    applies to every leaf).

    Every process contributes the shards its local devices own; the result
    is a global array usable inside ``jit``/``shard_map`` spanning all
    processes.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    def place(a, sp):
        a = np.asarray(a)
        sharding = NamedSharding(mesh, sp)
        return jax.make_array_from_callback(a.shape, sharding, lambda idx: a[idx])

    if isinstance(spec, PartitionSpec):
        return jax.tree_util.tree_map(lambda a: place(a, spec), tree)
    return jax.tree_util.tree_map(place, tree, spec)


def process_index() -> int:
    import jax

    return jax.process_index()


def process_count() -> int:
    import jax

    return jax.process_count()
