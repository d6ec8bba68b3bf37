"""Profiler scopes for the K-FAC hot paths (PyTorch port of
``distributed_kfac_pytorch_tpu/observability/profiling.py``).

``annotate(name)`` opens two ranges around a stage:

  - ``torch.profiler.record_function(name)``: a range on the host
    timeline of a ``torch.profiler`` trace; the kernels launched inside it
    are attributed to it (each CUDA launch records its correlation id), so
    the trace splits device time by K-FAC stage;
  - an NVTX range (``torch.cuda.nvtx``) when a CUDA device is present, for
    external timeline tools.

Neither launches a kernel or changes a number: the step under the scopes
is the step without them, bit for bit and launch for launch. With no
profiler session running, ``record_function`` costs a few microseconds
of host time per scope.

Scope names (the JAX package's):

  kfac/factors/<kind>_<side>  covariance contraction per layer kind
  kfac/eigh/<method>          eigendecompositions (warm, jacobi, xla,
                              lowrank)
  kfac/inverse/<method>       damped inverses (cholesky, newton), and
                              kfac/inverse/chunk<k> for a chunk firing
  kfac/precond/<branch>       preconditioning (eigen, inv, diag_a,
                              diag_a_eigen)
  kfac/comm/<collective>      the collectives of DistributedKFAC
  kfac/factors, kfac/inverses, kfac/precond
                              the three stages of a step as a whole

``start_trace`` / ``stop_trace`` wrap one ``torch.profiler.profile``
session (CPU and, where present, CUDA activity) with rank gating and
idempotence, so the CLIs can expose a bare ``--profile-dir``: the session
writes a Chrome trace (``<host>_<pid>.pt.trace.json``) into the
directory.
"""

from __future__ import annotations

import functools
import os
import socket

import torch


@functools.lru_cache(maxsize=None)
def _nvtx_on() -> bool:
    return torch.cuda.is_available()


class annotate:
    """Context manager: the ``record_function`` and NVTX ranges of one
    stage (see the module docstring)."""

    __slots__ = ('name', '_rf', '_nvtx')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._nvtx = _nvtx_on()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False


def scope(name: str):
    """Decorator form of :func:`annotate` (wraps the whole function)."""
    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return wrapper
    return decorator


_ACTIVE: dict = {}


def start_trace(log_dir: str, *, process_index: int = 0) -> bool:
    """Start a ``torch.profiler`` session that writes into ``log_dir``
    (rank 0 only). Returns True when a session started; a second call
    while one is active does nothing."""
    if _ACTIVE or process_index != 0:
        return False
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _ACTIVE.update(prof=prof, dir=log_dir)
    return True


def stop_trace() -> str | None:
    """Stop the active session and write its Chrome trace; returns the
    directory (None when no session was active). The card is synchronized
    first, so the steps launched inside the session are complete in it."""
    if not _ACTIVE:
        return None
    prof, log_dir = _ACTIVE.pop('prof'), _ACTIVE.pop('dir')
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f'{socket.gethostname()}_{os.getpid()}.pt.trace.json'))
    return log_dir


def trace_files(log_dir: str) -> list[str]:
    """The Chrome traces :func:`stop_trace` wrote under ``log_dir``."""
    try:
        names = sorted(os.listdir(log_dir))
    except FileNotFoundError:
        return []
    return [os.path.join(log_dir, n) for n in names
            if n.endswith('.pt.trace.json')]
