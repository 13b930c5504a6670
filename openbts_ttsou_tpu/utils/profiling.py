"""Profiling hooks (SURVEY §5: the reference has none beyond logging;
this build exposes the JAX profiler).

Usage:
    with profiling.trace("/tmp/trace"):      # XPlane trace for
        run_hot_path()                        # TensorBoard/xprof

or set OPENBTS_TRACE=<dir> and call `maybe_trace()` around a region
(bench.py does this for the timed section).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """`jax.profiler.trace` around the body; errors from the profiler
    and from the body both propagate."""
    import jax

    with jax.profiler.trace(log_dir):
        yield


@contextlib.contextmanager
def maybe_trace(env: str = "OPENBTS_TRACE") -> Iterator[None]:
    log_dir = os.environ.get(env)
    if not log_dir:
        yield
        return
    with trace(log_dir):
        yield

