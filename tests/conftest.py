"""Test configuration: run the suite on a virtual 8-device CPU mesh.

The reference tests multi-node behavior by oversubscribing MPI ranks on one
CI node (/root/reference/.github/workflows/main_ci.yml:33-41); we do the
same with XLA's virtual host devices: 8 CPU devices in one process, so all
shard_map collectives execute for real in CI without several accelerators.

Env vars alone are not enough here: pytest plugins (jaxtyping, hypothesis)
import jax before this conftest runs, so we also set the platform through
the jax config API, which works any time before the backend is first used.
"""

import os

import pytest

# PT_TEST_GPU=1 leaves the real backend in place so the `gpu`-marked tests
# run on the card:
#   PT_TEST_GPU=1 python -m pytest tests/ -m gpu
if os.environ.get("PT_TEST_GPU") != "1":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """Skip unless the test runs on the GPU backend (decided when the test
    runs, never at import or collection)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU backend (PT_TEST_GPU=1 on a GPU machine)")
