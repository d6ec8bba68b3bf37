"""Grace-period preemption handling for the train loop (PyTorch port of
``distributed_kfac_pytorch_tpu/resilience/preemption.py``).

Preemptible fleets announce eviction with a signal (SIGTERM from the
scheduler, SIGINT from an operator) a short grace window before the kill.
The handler turns that notice into a flag the train loop polls once per
step (``PreemptionHandler.triggered``); on it the loop forces a blocking
checkpoint save (``policy.StepCheckpointer``) and the CLI exits with
:data:`RELAUNCH_EXIT_CODE`, which a relaunch loop reads as "restart me";
any other exit code means done or failed. The signal handler only sets the
flag, so a signal that lands during a CUDA or collective call is acted on
at the end of the step.

``add_source(fn)`` registers a zero-argument callable polled beside the
flag; ``file_source`` is the built-in one: touching the
``KFAC_PREEMPT_FILE`` sentinel requests a drain.

Under a process group the flag is local: ``StepCheckpointer`` broadcasts
rank 0's verdict each step, so every rank saves (collectively) at the same
step.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable


def _relaunch_exit_code() -> int:
    """The "preempted with checkpoint saved, relaunch me" exit code:
    75 (EX_TEMPFAIL of sysexits.h) unless ``KFAC_RELAUNCH_EXIT`` sets
    another in 1..255."""
    raw = os.environ.get('KFAC_RELAUNCH_EXIT')
    if raw is None:
        return 75
    try:
        code = int(raw)
    except ValueError:
        raise ValueError(
            f'KFAC_RELAUNCH_EXIT={raw!r} is not an integer exit code'
        ) from None
    if not 1 <= code <= 255:
        # 0 means success to every supervisor; >255 wraps mod 256 on
        # POSIX and would silently alias another code.
        raise ValueError(
            f'KFAC_RELAUNCH_EXIT={code} must be in 1..255 (0 is '
            'success; values past 255 wrap on POSIX exit)')
    return code


# Relaunch loops run `while rc == RELAUNCH_EXIT_CODE`; read once at
# import, so an environment variable set on the relaunch loop reaches the
# children alike.
RELAUNCH_EXIT_CODE = _relaunch_exit_code()


class Preempted(Exception):
    """Raised out of the train loop after the forced preemption save; the
    checkpoint is durable when this propagates. ``partial`` is the record
    of the epoch's steps before the drain (``losses``, ``fired``,
    ``step_ms``): the epoch loop fills it, and it stays empty for a drain
    between epochs."""

    def __init__(self, global_step: int, reason: str = 'preempted'):
        super().__init__(f'{reason} at global step {global_step}')
        self.global_step = global_step
        self.reason = reason
        self.partial = {'losses': [], 'fired': [], 'step_ms': []}


def file_source(path: str) -> Callable[[], str | None]:
    """A trigger source that fires when ``path`` exists (``touch <path>``
    requests a graceful drain)."""

    def check():
        return f'sentinel file {path}' if os.path.exists(path) else None

    return check


class PreemptionHandler:
    """Signal-driven (and pluggable) preemption flag with a grace budget.

    Usage::

        handler = PreemptionHandler(grace_secs=30.0).install()
        ...
        if handler.triggered():          # polled once per step
            <blocking checkpoint save>
            raise Preempted(step, handler.reason)

    - First SIGTERM / SIGINT: set the flag and start the grace clock; the
      loop finishes the step, saves and exits with the relaunch code.
    - A second signal of the same kind restores the previous disposition
      (usually: terminate) and re-raises it, so a save stuck past the
      operator's patience can still be killed.
    - ``add_source``: extra zero-argument callables polled by
      ``triggered()``; a truthy return (used as the reason) triggers like
      a signal.
    """

    def __init__(self, grace_secs: float = 30.0,
                 signals=(signal.SIGTERM, signal.SIGINT)):
        self.grace_secs = float(grace_secs)
        self.signals = tuple(signals)
        self.reason: str | None = None
        self._triggered = False
        self._deadline: float | None = None
        self._prev: dict[int, object] = {}
        self._sources: list[Callable[[], str | None]] = []

    def install(self) -> 'PreemptionHandler':
        """Install the handlers (from the main thread)."""
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        if self._triggered:
            self._escalate(signum)
            return
        self.trigger(f'signal {signal.Signals(signum).name}')

    def _escalate(self, signum) -> None:
        """Second signal: restore the prior disposition and re-raise."""
        signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
        os.kill(os.getpid(), signum)

    def add_source(self, fn: Callable[[], str | None]) -> None:
        """Register an extra trigger source, polled by :meth:`triggered`."""
        self._sources.append(fn)

    def trigger(self, reason: str = 'preempted') -> None:
        """Request a graceful drain (signal handler, source or fault)."""
        if not self._triggered:
            self._triggered = True
            self.reason = reason
            self._deadline = time.monotonic() + self.grace_secs

    def triggered(self) -> bool:
        """The train loop's poll point (no system call unless sources are
        registered)."""
        if not self._triggered:
            for src in self._sources:
                why = src()
                if why:
                    self.trigger(str(why))
                    break
        return self._triggered

    def remaining_grace(self) -> float:
        """Seconds left in the grace budget (inf before triggering)."""
        if self._deadline is None:
            return float('inf')
        return self._deadline - time.monotonic()
