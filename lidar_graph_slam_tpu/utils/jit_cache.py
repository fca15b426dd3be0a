"""Persistent XLA compilation cache for the accelerator entry points.

The pipeline compiles about ten programs per capacity set, and a cold GPU compile pays
XLA's autotuning on top; the cache turns a rerun's compiles into loads. The entry points
(`bench.py`, the CLI, `scripts/at_scale.py`, `chip_smoke.py`) all call
`enable_compilation_cache()` once, before their first compile:

  * With `JAX_COMPILATION_CACHE_DIR` set, JAX reads that directory itself and this
    module configures nothing.
  * Otherwise the cache lives in `CACHE_DIR`, one fixed directory inside the checkout
    (git-ignored). The directory is part of what makes a run find an earlier run's
    entries, so it never depends on the user, the platform or the process.

The cache stays off when the default backend is the CPU (the test suite, the CPU-mesh
dryrun): CPU executables are built for the compiling host's instruction set, and an
in-checkout directory travels with copies of the checkout to other machines, where XLA
would load them anyway.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache(platform: str | None = None) -> bool:
    """Turn the persistent cache on for an accelerator backend; returns whether it is on.

    `platform` defaults to the default backend's (`jax.devices()[0].platform`)."""
    import jax

    if platform is None:
        platform = jax.devices()[0].platform
    if platform == "cpu":
        return False
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return True
