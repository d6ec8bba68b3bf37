"""Train / eval epoch loops over the single-device K-FAC step (PyTorch port
of ``distributed_kfac_pytorch_tpu/training/engine.py``: the classic
cadence of ``cadence_flags``, ``train_epoch`` and ``evaluate``).

The host drives the cadence (``factor_update`` / ``inv_update`` flags from
the step counter). Losses and accuracies stay device tensors until the
epoch's averages are read, so the loop does not sync the host each step
unless per-step times are asked for.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu_torch.training.utils import Metric, \
    accuracy


def cadence_flags(step: int, factor_update_freq, inv_update_freq,
                  inv_pipeline_chunks: int = 1) -> dict:
    """Static cadence flags for one host step: factors every
    ``factor_update_freq`` steps, the whole inverse update every
    ``inv_update_freq`` steps (the JAX package's classic schedule)."""
    if int(inv_pipeline_chunks) != 1:
        raise NotImplementedError(
            'pipelined inverse firing (inv_pipeline_chunks > 1) is not '
            'ported yet')
    return {'factor_update': step % int(factor_update_freq) == 0,
            'inv_update': step % int(inv_update_freq) == 0}


def fired_stage(flags: dict) -> str | None:
    """Most expensive stage a step's flags fire: 'inverse' > 'factor'."""
    if flags.get('inv_update'):
        return 'inverse'
    if flags.get('factor_update'):
        return 'factor'
    return None


@dataclasses.dataclass
class TrainState:
    """Everything a training step threads through."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    kfac: Any = None                 # KFAC or None (plain SGD)
    kfac_state: dict | None = None
    step: int = 0
    epoch: int = 0


def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
               hyper: dict, flags: dict) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """One forward/backward, K-FAC preconditioning and SGD update.
    Returns the (device) loss and accuracy of the batch."""
    loss_fn = lambda out: F.cross_entropy(out, y)  # noqa: E731
    kfac = state.kfac
    if kfac is None:
        state.optimizer.zero_grad(set_to_none=True)
        out = state.model(x)
        loss = loss_fn(out)
        loss.backward()
        state.optimizer.step()
        return loss.detach(), accuracy(out.detach(), y)
    loss, out, grads, captures = kfac.capture.loss_and_grads(
        loss_fn, x, intercept=flags['factor_update'])
    precond, state.kfac_state = kfac.step(
        state.kfac_state, grads, captures,
        damping=hyper.get('damping'), lr=hyper['lr'],
        factor_update=flags['factor_update'],
        inv_update=flags['inv_update'])
    for name, p in state.model.named_parameters():
        if name in precond:
            p.grad = precond[name]
    state.optimizer.step()
    return loss, accuracy(out, y)


def train_epoch(state: TrainState, batches: Iterable, hyper: dict, *,
                device, verbose: bool = False, time_steps: bool = False,
                max_steps: int | None = None) -> dict:
    """One training epoch; returns the averaged metrics and, per step,
    the device losses, the fired stage and (``time_steps``: each step
    synchronized) the wall milliseconds.

    ``hyper`` holds this epoch's ``lr`` and, with K-FAC, ``damping`` and
    the update frequencies (``KFACParamScheduler.params()``). Stops after
    ``max_steps`` global steps when given.
    """
    device = torch.device(device)
    state.model.train()
    meters: dict[str, Metric] = {}
    losses, fired, step_ms = [], [], []
    for xb, yb in batches:
        if max_steps is not None and state.step >= max_steps:
            break
        flags = (cadence_flags(state.step, hyper['factor_update_freq'],
                               hyper['inv_update_freq'])
                 if state.kfac is not None else {})
        x = torch.as_tensor(np.ascontiguousarray(xb), device=device)
        y = torch.as_tensor(yb, dtype=torch.long, device=device)
        t0 = time.perf_counter()
        loss, acc = train_step(state, x, y, hyper, flags)
        if time_steps:
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        fired.append(fired_stage(flags))
        meters.setdefault('loss', Metric('loss')).update(loss)
        meters.setdefault('acc', Metric('acc')).update(acc)
        state.step += 1
    out = {k: m.avg for k, m in meters.items()}
    if verbose and out:
        shown = {k: round(v, 4) for k, v in out.items()}
        print(f'epoch {state.epoch}: train {shown}')
    return {'metrics': out, 'losses': [float(v) for v in losses],
            'fired': fired, 'step_ms': step_ms if time_steps else None}


@torch.no_grad()
def evaluate(model: torch.nn.Module, batches: Iterable, *, device,
             epoch: int = 0, verbose: bool = False) -> dict[str, float]:
    """Eval loop (BN in eval mode); returns the averaged loss/accuracy."""
    device = torch.device(device)
    model.eval()
    meters: dict[str, Metric] = {}
    for xb, yb in batches:
        x = torch.as_tensor(np.ascontiguousarray(xb), device=device)
        y = torch.as_tensor(yb, dtype=torch.long, device=device)
        out = model(x)
        meters.setdefault('loss', Metric('loss')).update(
            F.cross_entropy(out, y))
        meters.setdefault('acc', Metric('acc')).update(accuracy(out, y))
    if not meters:
        raise ValueError(
            'evaluate: the batch iterator yielded ZERO batches -- usually '
            'a val batch size larger than the val set')
    out = {k: m.avg for k, m in meters.items()}
    if verbose:
        print(f'epoch {epoch}: val '
              f'{ {k: round(v, 4) for k, v in out.items()} }')
    return out
