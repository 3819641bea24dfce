"""Process-level JAX platform and compilation-cache setup.

- Platform: JAX's default (the GPU where there is one). ``PM_PLATFORM``
  (e.g. ``cpu``) selects another explicitly.
- Persistent compilation cache: where ``JAX_COMPILATION_CACHE_DIR`` is set,
  JAX keeps the cache there by itself and this module sets no other path.
  Otherwise the cache goes to the fixed ``<checkout>/.jax_cache``
  (``.gitignore`` lists it), so a later process of the same checkout skips
  the compilation of programs it has already built.

Call ``setup()`` once, before building any model — every app, benchmark and
script entry point does.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup(platform: str | None = None) -> None:
    import jax

    platform = platform or os.environ.get("PM_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
