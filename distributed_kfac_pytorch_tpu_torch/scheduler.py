"""Epoch-schedule decay of K-FAC hyperparameters (PyTorch port of
``distributed_kfac_pytorch_tpu/scheduler.py``; pure Python, unchanged
semantics).

The scheduler *returns* the current hyperparameter values; the training
loop passes them into ``KFAC.step(...)``.
"""

from __future__ import annotations

from typing import Sequence


def _factor_func(schedule: Sequence[int] | None, alpha: float):
    """Multiplicative decay factor as a function of the step/epoch count.

    Reference parity: kfac/scheduler.py:65-79 (note: the reference sorts
    the schedule in reverse but still multiplies once per passed
    threshold; behavior is order-independent, kept simple here).
    """
    sched = sorted(schedule) if schedule else []

    def factor(step: int) -> float:
        f = 1.0
        for t in sched:
            if step >= t:
                f *= alpha
        return f

    return factor


class KFACParamScheduler:
    """StepLR-style scheduler for damping and update frequencies.

    Args:
      kfac: the KFAC preconditioner whose base hyperparameters to scale.
      damping_alpha: multiplicative damping factor (default 1).
      damping_schedule: epochs at which to multiply damping by
        ``damping_alpha``.
      update_freq_alpha: multiplicative update-frequency factor (default 1).
      update_freq_schedule: epochs at which to multiply both
        ``factor_update_freq`` and ``inv_update_freq``.
      start_step: starting epoch counter (for checkpoint resume).

    Call ``step()`` once per epoch, then read ``params()`` (or the
    individual properties) and feed them to ``KFAC.step``.
    """

    def __init__(self, kfac, *,
                 damping_alpha: float = 1.0,
                 damping_schedule: Sequence[int] | None = None,
                 update_freq_alpha: float = 1.0,
                 update_freq_schedule: Sequence[int] | None = None,
                 start_step: int = 0):
        self.damping_base = kfac.damping
        self.factor_update_freq_base = kfac.factor_update_freq
        self.inv_update_freq_base = kfac.inv_update_freq
        self.damping_alpha = damping_alpha
        self.damping_schedule = (list(damping_schedule)
                                 if damping_schedule else None)
        self.update_freq_alpha = update_freq_alpha
        self.update_freq_schedule = (list(update_freq_schedule)
                                     if update_freq_schedule else None)
        self._damping_factor = _factor_func(damping_schedule, damping_alpha)
        self._freq_factor = _factor_func(update_freq_schedule,
                                         update_freq_alpha)
        self._step = start_step

    @property
    def damping(self) -> float:
        return self.damping_base * self._damping_factor(self._step)

    @property
    def factor_update_freq(self) -> int:
        return max(1, int(self.factor_update_freq_base *
                          self._freq_factor(self._step)))

    @property
    def inv_update_freq(self) -> int:
        return max(1, int(self.inv_update_freq_base *
                          self._freq_factor(self._step)))

    def params(self) -> dict:
        """Current kwargs for ``KFAC.step``."""
        return {'damping': self.damping,
                'factor_update_freq': self.factor_update_freq,
                'inv_update_freq': self.inv_update_freq}

    def step(self, step: int | None = None) -> dict:
        """Advance (or jump) the epoch counter; returns current params.

        Reference parity: kfac/scheduler.py:81-94.
        """
        self._step = self._step + 1 if step is None else step
        return self.params()

    def state_dict(self) -> dict:
        return {'step': self._step,
                'damping_base': self.damping_base,
                'damping_alpha': self.damping_alpha,
                'damping_schedule': self.damping_schedule,
                'factor_update_freq_base': self.factor_update_freq_base,
                'inv_update_freq_base': self.inv_update_freq_base,
                'update_freq_alpha': self.update_freq_alpha,
                'update_freq_schedule': self.update_freq_schedule}

    def load_state_dict(self, sd: dict) -> None:
        self._step = sd['step']
        self.damping_base = sd['damping_base']
        self.damping_alpha = sd['damping_alpha']
        self.damping_schedule = sd['damping_schedule']
        self.factor_update_freq_base = sd['factor_update_freq_base']
        self.inv_update_freq_base = sd['inv_update_freq_base']
        self.update_freq_alpha = sd['update_freq_alpha']
        self.update_freq_schedule = sd['update_freq_schedule']
        self._damping_factor = _factor_func(self.damping_schedule,
                                            self.damping_alpha)
        self._freq_factor = _factor_func(self.update_freq_schedule,
                                         self.update_freq_alpha)
