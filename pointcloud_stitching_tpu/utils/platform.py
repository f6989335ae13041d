"""Process-level JAX setup: the compile cache and the kernel choice.

``setup_compilation_cache`` is called once by every entry point (CLIs,
``bench.py``, ``chip_smoke.py``, ``__graft_entry__.py``). ``kernel_impl`` is
the one place that decides between a hand-written Pallas kernel and the
plain XLA form of an op.
"""
from __future__ import annotations

import os

_KERNEL_IMPLS = ("auto", "pallas", "xla")


def compilation_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``.

    The fallback is derived from the package's own path, so every process
    run from one checkout finds the same cache (the path is part of what
    the cache is keyed on; a directory that moves never hits).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def setup_compilation_cache() -> str:
    """Point JAX's persistent compile cache at ``compilation_cache_dir()``.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, so this
    sets nothing and only reports it.
    """
    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def kernel_impl(impl: str = "auto", interpret: bool = False) -> str:
    """Resolve a kernel choice to 'pallas' or 'xla'.

    'auto' takes the Pallas kernel on an NVIDIA GPU and XLA elsewhere.
    'pallas' needs a GPU, or ``interpret=True`` on a host without one (the
    CPU tests); interpret mode is refused on a GPU so that a slow
    interpreted kernel can never stand in for the compiled one there.
    """
    if impl not in _KERNEL_IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one of "
                         f"{_KERNEL_IMPLS}")
    import jax
    gpu = jax.default_backend() == "gpu"
    if impl == "xla":
        return impl
    if interpret and gpu:
        raise ValueError("interpret=True is for hosts without a GPU; "
                         "on a GPU the kernel runs compiled")
    if impl == "auto":
        return "pallas" if gpu else "xla"
    if not interpret and not gpu:
        raise RuntimeError(
            "the Pallas kernels compile only for an NVIDIA GPU (backend "
            f"here: {jax.default_backend()!r}); use impl='xla', or "
            "interpret=True to run the kernel in interpret mode")
    return impl
