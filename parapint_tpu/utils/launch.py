"""Start-up helpers for the repository's launchers (bench, smoke, entry)."""

import os

import jax

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at a fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing is changed
    (JAX reads it itself).  Otherwise the cache lives in ``.jax_cache`` at
    the root of the checkout, a fixed path so that later runs hit it.
    Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> str:
    """Refuse to measure on anything but the GPU, unless the CPU was asked
    for explicitly with ``JAX_PLATFORMS=cpu``.  Returns the backend name."""
    backend = jax.default_backend()
    if backend != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(
            f"no GPU backend (found {backend!r}); set JAX_PLATFORMS=cpu to "
            f"run on the CPU on purpose"
        )
    return backend


def device_info() -> dict:
    """The device as JAX reports it."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}
