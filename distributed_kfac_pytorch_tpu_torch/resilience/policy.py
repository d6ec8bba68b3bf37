"""Step-level checkpoint policy on top of ``CheckpointManager`` (PyTorch
port of ``distributed_kfac_pytorch_tpu/resilience/policy.py``).

Epoch bundles (the CLIs' ``--checkpoint-freq``) lose up to an epoch of
work on preemption. :class:`StepCheckpointer` adds global-step bundles in
the ``steps/`` subdirectory of the run's checkpoint tree, driven by a step
interval (``--checkpoint-steps N``), a wall-clock interval
(``--checkpoint-secs S``) and preemption: when the polled
``preemption.PreemptionHandler`` has triggered, a blocking save runs
whatever the intervals and :class:`Preempted` is raised so that the CLI
exits with the relaunch code. Each bundle carries its resume point
(``epoch``, ``step_in_epoch``, ``data_seed``; see :mod:`dataiter`). Every
save is synchronous (the JAX package writes asynchronously).

Under a process group saves are collective, so the decision must be the
same on every rank: rank 0's two bits (preempted, due) are broadcast each
step and every rank acts on them (:meth:`StepCheckpointer._agree`). The
``KFAC_CHAOS`` fault plan (:mod:`faults`) is polled here, at the point
where the real failures would act.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from distributed_kfac_pytorch_tpu_torch.resilience import \
    faults as faults_lib
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import (
    Preempted,
    PreemptionHandler,
)


class CheckpointPolicy:
    """Pure decision logic: is a step checkpoint due?

    ``every_steps`` counts global optimizer steps since the last step
    save (robust across resumes); ``every_secs`` wall-clock seconds since
    the last step save. Either at 0 is off; both at 0 leaves only forced
    (preemption) saves.
    """

    def __init__(self, every_steps: int = 0, every_secs: float = 0.0,
                 *, start_step: int = 0, clock=time.monotonic):
        if every_steps < 0 or every_secs < 0:
            raise ValueError('checkpoint intervals must be >= 0, got '
                             f'{every_steps=} {every_secs=}')
        self.every_steps = int(every_steps)
        self.every_secs = float(every_secs)
        self._clock = clock
        self._last_step = int(start_step)
        self._last_time = clock()

    def should_save(self, global_step: int) -> bool:
        if self.every_steps and \
                global_step - self._last_step >= self.every_steps:
            return True
        if self.every_secs and \
                self._clock() - self._last_time >= self.every_secs:
            return True
        return False

    def note_saved(self, global_step: int) -> None:
        self._last_step = int(global_step)
        self._last_time = self._clock()


class StepCheckpointer:
    """Per-step checkpoint, preemption and fault-injection hook.

    ``engine.train_epoch`` calls :meth:`after_step` once per completed
    step; the epoch loops call :meth:`poll` between epochs.
    ``bundle_fn(state, step_in_epoch) -> tree`` assembles the bundle (the
    CLI closes over its model and optimizer). The saves' ``(global step,
    ms)`` are kept in :attr:`saves` and, with ``verbose``, printed.
    ``sink`` (an ``observability.sink.JsonlMetricsSink`` or None) takes a
    ``checkpoint_save`` event per save and a ``preemption`` event per
    drain, with the JAX package's fields.
    """

    def __init__(self, mgr, policy: CheckpointPolicy | None, bundle_fn,
                 *, preemption: PreemptionHandler | None = None,
                 plan: faults_lib.FaultPlan | None = None,
                 verbose: bool = False, sink=None):
        self.mgr = mgr
        self.policy = policy
        self.bundle_fn = bundle_fn
        self.preemption = preemption
        self.plan = plan
        self.verbose = verbose
        self.sink = sink
        self.saves: list[tuple[int, float]] = []
        self._fired: set[str] = set()

    def after_step(self, state, step_in_epoch: int) -> None:
        """Called after each completed step with the steps finished in
        the current epoch (the resume offset included). May raise
        :class:`Preempted`, after the blocking save."""
        gstep = int(state.step)
        if self.plan is not None:
            if self.plan.crash_at == gstep:
                faults_lib.hard_crash()
            # corrupt-factor and diverge: live-state faults, once each.
            faults_lib.inject_state_faults(self.plan, state, self._fired)
            if self.plan.corrupt_ckpt_at == gstep and \
                    self._once('corrupt-ckpt'):
                # Bit-rot a committed bundle: save, then flip a byte in its
                # largest file.
                self.save(state, step_in_epoch)
                if _rank() == 0:
                    faults_lib.corrupt_bundle_file(self.mgr.directory,
                                                   gstep)
            if self.plan.preempt_at == gstep and \
                    self.preemption is not None:
                self.preemption.trigger('injected preemption')
        preempted = (self.preemption is not None
                     and self.preemption.triggered())
        due = self.policy is not None and self.policy.should_save(gstep)
        preempted, due = self._agree(preempted, due)
        if preempted:
            self._drain(state, step_in_epoch)
        if due:
            self.save(state, step_in_epoch)

    def _drain(self, state, step_in_epoch: int) -> None:
        """The forced blocking save, then :class:`Preempted`."""
        gstep = int(state.step)
        self.save(state, step_in_epoch, forced=True)
        reason = ((self.preemption.reason if self.preemption else None)
                  or 'preempted')
        self._event('preemption', global_step=gstep, reason=reason,
                    grace_remaining_s=round(
                        self.preemption.remaining_grace(), 3)
                    if self.preemption else None)
        raise Preempted(gstep, reason)

    def _once(self, key: str) -> bool:
        """True the first time ``key`` fires in this process."""
        if key in self._fired:
            return False
        self._fired.add(key)
        return True

    @staticmethod
    def _agree(preempted: bool, due: bool) -> tuple[bool, bool]:
        """The save decision, the same on every rank.

        ``mgr.save`` is collective, so a decision one rank took alone
        would hang the group: a signal can land between two ranks' polls,
        and wall clocks tip over at different steps. Rank 0 decides: its
        bits are broadcast each step (``torch.distributed.broadcast``)
        and every rank acts on them. Alone: the local bits.
        """
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return preempted, due
        device = ('cuda' if dist.get_backend() == 'nccl' else 'cpu')
        bits = torch.tensor([(1 if preempted else 0) | (2 if due else 0)],
                            dtype=torch.int32, device=device)
        dist.broadcast(bits, src=0)
        agreed = int(bits.item())
        return bool(agreed & 1), bool(agreed & 2)

    def poll(self, state, step_in_epoch: int = 0) -> None:
        """Epoch-boundary preemption check (no interval logic, no faults;
        collective under a process group): a signal that landed during
        evaluation or an epoch save drains here."""
        preempted = (self.preemption is not None
                     and self.preemption.triggered())
        if self._agree(preempted, False)[0]:
            self._drain(state, step_in_epoch)

    def save(self, state, step_in_epoch: int, *,
             forced: bool = False) -> None:
        """Save the global-step bundle of ``state`` (every save blocks;
        ``forced``: the preemption drain's)."""
        gstep = int(state.step)
        crash = (faults_lib.hard_crash if self.plan is not None
                 and self.plan.crash_in_save_at == gstep else None)
        t0 = time.perf_counter()
        self.mgr.save(gstep, self.bundle_fn(state, int(step_in_epoch)),
                      force=True, before_commit=crash)
        ms = (time.perf_counter() - t0) * 1000.0
        if self.policy is not None:
            self.policy.note_saved(gstep)
        self.saves.append((gstep, ms))
        # Every save blocks (the JAX package's default ones are async).
        self._event('checkpoint_save', global_step=gstep,
                    step_in_epoch=int(step_in_epoch),
                    latency_ms=round(ms, 3), blocking=True,
                    forced=bool(forced))
        if self.verbose:
            print(f'checkpoint: step {gstep} saved in {ms:.1f} ms'
                  + (' (forced)' if forced else ''), flush=True)

    def _event(self, name: str, **data) -> None:
        if self.sink is not None:
            self.sink.event_record(name, **data)

    def close(self) -> None:
        self.mgr.close()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0
