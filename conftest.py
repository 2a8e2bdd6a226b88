"""Turn JAX's persistent compilation cache off in pytest-xdist workers.

tests/conftest.py turns the cache on (``kube_arbitrator_tpu.platform.
enable_persistent_cache``).  Under xdist, with several workers compiling
at once, its read and write paths crash a worker now and then (a segfault
in ``compilation_cache.get_executable_and_time`` reading an entry another
worker is still writing, and in ``put_executable_and_time`` writing one to
a directory no other worker uses), and the test the worker was running
fails.  ``jax_enable_compilation_cache = False`` disables the cache
whatever directory is set later, so each worker compiles in memory.  This
file sits above tests/ so pytest imports it first; a run without xdist
keeps the cache.
"""
import os

if os.environ.get("PYTEST_XDIST_WORKER"):
    import jax

    jax.config.update("jax_enable_compilation_cache", False)
