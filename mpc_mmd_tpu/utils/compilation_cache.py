"""Persistent XLA compilation cache setup.

The mmd_opt solve program nests a 20-iteration inner CEM vmapped over 100
candidates inside the 20-iteration outer scan, so a cold compile takes a long
time.  A persistent on-disk cache makes every process after the first load a
compiled executable instead, which is what lets short-lived entry points
(bench.py, chip_smoke.py, __graft_entry__.py, the CLIs) start fast.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set, and
otherwise at the fixed ``<repo>/.jax_cache`` (the path is part of nothing
volatile: no temporary name, pid or time, so a later process finds it again).

The reference has no counterpart (it keeps one long-lived Python process per
sweep, synthetic_static_obs/main_mpc.py:106).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """Where the persistent cache lives: ``$JAX_COMPILATION_CACHE_DIR`` if
    set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Point JAX's compilation cache at :func:`cache_dir`.

    Call BEFORE the first jit compilation.  Returns the directory in use, or
    "" on the CPU backend: XLA:CPU serializes AOT results keyed loosely
    enough that an entry compiled under one host's CPU feature set can be
    loaded on another (mismatch warnings, potential SIGILL), and CPU
    compiles here are seconds anyway.
    """
    import jax

    if jax.default_backend() == "cpu":
        return ""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # Cache every program (defaults skip compiles <1s / small executables —
    # we want the whole pipeline warm, including tiny helper programs).
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
