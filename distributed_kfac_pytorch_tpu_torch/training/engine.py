"""Train / eval epoch loops over the K-FAC step (PyTorch port of
``distributed_kfac_pytorch_tpu/training/engine.py``: the cadence of
``cadence_flags``, classic, pipelined, stale and deferred, ``train_epoch``
and ``evaluate``), the epoch loop
the image CLIs share (``fit``) and the language-model step and loop of
the LM CLI (``lm_train_step``, ``fit_lm``, ``evaluate_lm``).

The host drives the cadence (``factor_update`` / ``inv_update`` flags from
the step counter). Losses and accuracies stay device tensors until the
epoch's averages are read, so the loop does not sync the host each step
unless per-step times are asked for.

Data parallelism (a ``TrainState`` with ``distributed=True``, in an
initialized ``torch.distributed`` world): every rank draws the same
global batch and trains on its ``launch.process_local_slice``; after the
backward pass one ``all_reduce`` averages the gradients (with the loss
and accuracy) over the world -- explicitly, not through DDP, since the
K-FAC capture owns the backward pass -- then ``DistributedKFAC.step``
preconditions, and after the update the BatchNorm running buffers are
averaged over the world. The LM step does the same (it has no buffers),
then clips the replicated update by its global norm; its validation loss
is the world's mean over the ranks' slices. Under sequence parallelism
each rank trains on its ``launch.process_local_tile`` (a slice of the
sequences and a block of positions, passed as ``pos_offset``) and
evaluates whole sequences of its K-FAC rank's slice without the ring.

Gradient accumulation (``TrainState.grad_accum = N``, the JAX
``build_train_step(grad_accum_steps=)``): :func:`accumulate_pass` splits
the rank's batch into ``N`` micro-batches run one after another (the
BatchNorm running statistics updated by each in turn, as JAX's scan
threads ``batch_stats``), sums the losses, accuracies and gradients and,
on factor steps, each micro-batch's K-FAC factor contributions (its
captures reduced and freed before the next forward pass, so memory stays
flat in ``N``), in fp32, then scales by ``1/N`` (the contributions'
output-grad-quadratic parts by ``1/N^2`` more). Precise-BN
(:func:`precise_bn_recalibrate`) re-estimates the BatchNorm running
statistics before an evaluation; :func:`fit` restores the training
statistics afterwards.

Dynamic loss scaling (``TrainState.loss_scale``, the JAX
``build_train_step(loss_scale='dynamic')``; the CLIs' ``--fp16``): each
pass scales its loss by the live scale and unscales its gradients and
output-gradient captures to fp32 (``KFACCapture.loss_and_grads``, each
micro-batch's before the sum), and after the world's mean one finiteness
flag over every gradient and every capture (or accumulated contribution)
is read on the host (the JAX step selects on the device; the port takes
GradScaler's one read per step). A non-finite capture skips the step:
JAX zeroes it (``fp16.sanitize_captures``) and steps on when the
gradients are finite, which no model reaches, since a non-finite
capture makes the gradients non-finite; the check reads each capture
once and copies none. On overflow the step runs no K-FAC step and no
optimizer step and leaves the parameters, the SGD momentum, every
``kfac_state`` tensor and the BatchNorm buffers (restored from a
snapshot taken before the forward pass) bit for bit as they were; only
``kfac_state['step']`` and the loss-scale state advance
(``fp16.update_loss_scale``). The mean carries any rank's non-finite
value to every rank, so every rank skips.

Checkpoints (:func:`start_checkpointing`, the JAX CLIs' wiring shared by
the three CLIs): the epoch loops resume at a bundle's point, skipping the
epoch's trained batches, call the ``resilience.policy.StepCheckpointer``
after each step (global-step bundles, the preemption drain, the
``KFAC_CHAOS`` faults), poll for preemption between epochs and save the
epoch bundle every ``--checkpoint-freq`` epochs and after the last. The
CLI flags the port does not run are :data:`UNPORTED_FLAGS`.

Metrics (the JAX engine's ``metrics_sink=`` and ``log_writer=``): with an
``observability.sink.JsonlMetricsSink`` the epoch loops enqueue one step
record per step (:func:`step_metrics`: the loss, accuracy, loss scale
and overflow, and the ``kfac/*`` metrics of ``KFAC(collect_metrics=
True)``), with the host wall of the step call (no synchronize) and its
fired stage; the sink snapshots the device scalars and reads them later.
Pending first-use kernel builds (``ops.kernels.drain_build_events``) go
into the stream as ``compile`` events after the step that triggered them,
and label a plain step ``'compile'``. At the epoch's end (and when a
preemption drains) an epoch record with the epoch's averages is appended
and the sink flushed; the ``kfac/*`` entries join the averages through
``Metric`` (summed on the device, read once). A :class:`TensorBoardWriter`
(``--log-dir``) gets the epoch's train and validation averages. The
step's host time joins the trace table (``observability.tracing``,
``train_step_dispatch``), whose snapshot each epoch record carries.

Observers beside the sink (:class:`Observers`, :func:`make_observers`;
all off by default, and off the step is the plain step): a
``kind='memory'`` record every ``memory_interval`` steps (the allocator
watermarks and the K-FAC state footprint, computed once per epoch); a
rank's straggler shard record per step, with the barrier probe's wait on
the steps it samples; a ``torch.profiler`` session over the first trained
epoch (``--profile-dir``); and the self-healing ladder
(``resilience.selfheal``): :meth:`~SelfHealController.adjust_hyper`
before each step (escalated damping, the quarantine gates) and
:meth:`~SelfHealController.observe` after it. A :class:`Rollback` leaves
the epoch with the sinks flushed; the epoch loop restores the newest
verified, finite step bundle at or before the fault and trains on in the
same process. Under hierarchical reduction a window head's fired stage
is recorded as ``dcn_reduce`` (the cross-slice collective), which
``observability.stragglers.stage_class`` attributes apart.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
import warnings
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu_torch import fp16 as fp16_lib
from distributed_kfac_pytorch_tpu_torch import launch, multislice
from distributed_kfac_pytorch_tpu_torch.layers import GRAD_QUADRATIC_KEYS
from distributed_kfac_pytorch_tpu_torch.models.transformer_lm import \
    whole_sequences
from distributed_kfac_pytorch_tpu_torch.observability import \
    cli as obs_cli
from distributed_kfac_pytorch_tpu_torch.observability import \
    memory as obs_memory
from distributed_kfac_pytorch_tpu_torch.observability import \
    metrics as obs_metrics
from distributed_kfac_pytorch_tpu_torch.observability import \
    stragglers as obs_stragglers
from distributed_kfac_pytorch_tpu_torch.observability import tracing
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.resilience import \
    cli as resilience_cli
from distributed_kfac_pytorch_tpu_torch.resilience import faults
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import (
    RELAUNCH_EXIT_CODE,
    Preempted,
    PreemptionHandler,
)
from distributed_kfac_pytorch_tpu_torch.resilience.selfheal import (
    Rollback,
    handle_rollback,
)
from distributed_kfac_pytorch_tpu_torch.training import checkpoint, \
    datasets, optimizers
from distributed_kfac_pytorch_tpu_torch.training.utils import Metric, \
    accuracy


def cadence_flags(step: int, factor_update_freq, inv_update_freq,
                  inv_pipeline_chunks: int = 1, *,
                  deferred_reduce: bool = False,
                  inv_staleness: int = 0) -> dict:
    """Cadence flags for one host step (the JAX package's schedule).

    Factors every ``factor_update_freq`` steps. The whole inverse update
    every ``inv_update_freq`` steps; with ``inv_pipeline_chunks = k > 1``
    chunk ``j`` fires at phase ``j * inv_update_freq / k`` of each window
    (``inv_chunk``) instead, except at step 0, which fires monolithically
    (every inverse slot must exist before its first use).
    ``inv_staleness=1``: window heads past step 0 take a factor snapshot
    (``factor_snapshot``) instead of firing, and chunk ``j`` fires at
    phase ``j * stride + 1`` from it (``k == 1``: the whole firing at
    phase 1). ``deferred_reduce`` adds ``factor_reduce`` on window heads.
    A chunk count that does not divide ``inv_update_freq`` (or staleness
    whose shifted phases do not fit) fires monolithically.
    """
    f_freq, i_freq = int(factor_update_freq), int(inv_update_freq)
    k = int(inv_pipeline_chunks)
    phase = step % i_freq
    flags = {'factor_update': step % f_freq == 0}
    if int(inv_staleness) == 1 and i_freq % k == 0 and i_freq // k >= 2:
        stride = i_freq // k
        flags['inv_update'] = step == 0
        if step != 0:
            if phase == 0:
                flags['factor_snapshot'] = True
            elif (phase - 1) % stride == 0 and (phase - 1) // stride < k:
                flags['inv_chunk'] = (phase - 1) // stride
    elif k > 1 and i_freq % k == 0:
        stride = i_freq // k
        flags['inv_update'] = step == 0
        if step != 0 and phase % stride == 0:
            flags['inv_chunk'] = phase // stride
    else:
        flags['inv_update'] = step % i_freq == 0
    if deferred_reduce:
        flags['factor_reduce'] = phase == 0
    return flags


def fired_stage(flags: dict) -> str | None:
    """Most expensive stage a step's flags fire: 'inverse' > 'chunk<j>' >
    'reduce' (the deferred window-head factor reduction) > 'factor' >
    None; a firing step that also reduces is 'inverse+reduce' or
    'chunk<j>+reduce'."""
    reduce_tag = '+reduce' if flags.get('factor_reduce') else ''
    if flags.get('inv_update'):
        return 'inverse' + reduce_tag
    if flags.get('inv_chunk') is not None:
        return f"chunk{flags['inv_chunk']}" + reduce_tag
    if flags.get('factor_reduce'):
        return 'reduce'
    if flags.get('factor_update'):
        return 'factor'
    return None


def epoch_schedule(kfac, inv_update_freq) -> dict:
    """The ``cadence_flags`` keywords of one epoch at ``inv_update_freq``
    for a ``KFAC`` or ``DistributedKFAC`` (the JAX ``train_epoch``
    rules): a chunk count that does not divide the epoch's frequency
    (after ``--kfac-update-freq-decay``, say) fires monolithically for
    the epoch, and staleness whose shifted phases do not fit (``freq /
    chunks < 2``) fires eagerly and monolithically at the window heads;
    each warns."""
    if kfac is None:
        return {}
    kfac = getattr(kfac, 'kfac', kfac)      # a DistributedKFAC's KFAC
    k = kfac.inv_pipeline_chunks
    freq = int(inv_update_freq)
    staleness = kfac.inv_staleness
    chunks = k
    if chunks > 1 and freq % chunks != 0:
        warnings.warn(
            f'inv_pipeline_chunks={chunks} does not divide this '
            f'epoch\'s inv_update_freq={freq} — firing '
            'monolithically for the epoch')
        chunks = 1
    if staleness and (freq % k != 0 or freq // k < 2):
        warnings.warn(
            f'inv_staleness=1 with inv_pipeline_chunks={k} does not fit '
            f'this epoch\'s inv_update_freq={freq} (needs freq/chunks '
            '>= 2) — firing eagerly/monolithically at window heads '
            'for the epoch')
        staleness, chunks = 0, 1
    return {'inv_pipeline_chunks': chunks, 'inv_staleness': staleness,
            'deferred_reduce': kfac.window_reduce}


def kfac_step_flags(flags: dict) -> dict:
    """The keywords of ``KFAC.step`` / ``DistributedKFAC.step`` in a
    step's cadence flags."""
    return {k: flags[k] for k in ('factor_update', 'inv_update',
                                  'inv_chunk', 'factor_reduce',
                                  'factor_snapshot') if k in flags}


@dataclasses.dataclass
class TrainState:
    """Everything a training step threads through."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    kfac: Any = None                 # KFAC, DistributedKFAC or None (SGD)
    kfac_state: dict | None = None
    step: int = 0
    epoch: int = 0
    distributed: bool = False        # data parallel over the world
    grad_accum: int = 1              # micro-batches per step
    # Dynamic loss-scale state (fp16.init_loss_scale) or None (no scaling).
    loss_scale: dict | None = None
    overflow: bool = False           # the last step was skipped


def world_mean(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The world's mean of each tensor, as one flat ``all_reduce``."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    return [v.view(t.shape).to(t.dtype)
            for v, t in zip(flat.split([t.numel() for t in tensors]),
                            tensors)]


def average_buffers(model: torch.nn.Module) -> None:
    """Average the floating-point buffers (BatchNorm running statistics)
    over the world, in place."""
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    if bufs:
        torch._foreach_copy_(bufs, world_mean(bufs))


def micro_batches(x: torch.Tensor, y: torch.Tensor, n: int) -> list:
    """``n`` equal consecutive ``(x, y)`` slices of a rank's batch (JAX's
    ``ValueError`` when ``n`` does not divide it)."""
    if n < 1:
        raise ValueError(f'grad_accum_steps={n} must be >= 1')
    if x.shape[0] % n:
        raise ValueError(f'per-device batch shard of {x.shape[0]} is not '
                         f'divisible by grad_accum_steps={n}')
    size = x.shape[0] // n
    return list(zip(x.split(size), y.split(size)))


def _one_pass(state: TrainState, x: torch.Tensor, y: torch.Tensor,
              criterion: Callable, intercept: bool) -> tuple:
    """One forward/backward pass: ``(loss, acc, grads, captures)``, with
    K-FAC's capture recording when ``intercept`` (else ``{}``); under a
    dynamic loss scale the loss is scaled, the gradients and captures
    come back unscaled."""
    loss_fn = lambda out: criterion(out, y)  # noqa: E731
    if state.kfac is None:
        state.optimizer.zero_grad(set_to_none=True)
        out = state.model(x)
        loss = loss_fn(out)
        loss.backward()
        loss, out = loss.detach(), out.detach()
        grads = {n: p.grad for n, p in state.model.named_parameters()
                 if p.grad is not None}
        captures = {}
    else:
        loss, out, grads, captures = _kfac_pass(state, loss_fn, x,
                                                intercept)
    return loss, accuracy(out, y), grads, captures


def _kfac_pass(state: TrainState, loss_fn: Callable, x: torch.Tensor,
               intercept: bool, **kwargs) -> tuple:
    """``KFACCapture.loss_and_grads`` at the live loss scale (None without
    one)."""
    scale = state.loss_scale and state.loss_scale['scale']
    return state.kfac.capture.loss_and_grads(
        loss_fn, x, intercept=intercept, loss_scale=scale, **kwargs)


def _capture_check(state: TrainState, captures) -> list[torch.Tensor]:
    """Under a dynamic loss scale with ``captures`` (or accumulated
    contributions) this step, ``[flag]``: 0.0 when all are finite, else
    NaN, which the world's mean carries to every rank beside the
    gradients for :func:`_overflow_skip`; else ``[]``."""
    if state.loss_scale is None or not captures:
        return []
    finite = fp16_lib.tree_all_finite(captures)
    return [torch.where(finite, 0.0, float('nan'))]


def _buffer_snapshot(state: TrainState) -> dict[str, torch.Tensor] | None:
    """Under a dynamic loss scale, a copy of every buffer of the model
    (the BatchNorm running statistics the forward pass writes in place)
    for :func:`_overflow_skip`; else None. The scale needs the K-FAC
    step (the SGD baseline does not wire the loss scaler)."""
    if state.loss_scale is None:
        return None
    if state.kfac is None:
        raise ValueError('a dynamic loss scale needs the K-FAC step (the '
                         'SGD baseline does not wire the loss scaler)')
    return {k: b.clone() for k, b in state.model.named_buffers()}


def _overflow_skip(state: TrainState, checked: list[torch.Tensor],
                   buffers: dict[str, torch.Tensor]) -> bool:
    """The dynamic loss scale's decision on the world's mean gradients and
    :func:`_capture_check` flag (``checked``): one finiteness flag, read
    on the host (the step's one sync), advances
    ``state.loss_scale``. On overflow the buffers go back to ``buffers``
    and ``kfac_state['step']`` advances (the cadence stays aligned with
    the host counter); returns True, and the caller leaves the K-FAC
    step, the optimizer and the buffers' world mean out."""
    finite = fp16_lib.tree_all_finite(checked)
    state.loss_scale = fp16_lib.update_loss_scale(state.loss_scale, finite)
    state.overflow = not bool(finite)
    if state.overflow:
        restore_buffers(state.model, buffers)
        state.kfac_state = {**state.kfac_state,
                            'step': state.kfac_state['step'] + 1}
    return state.overflow


def accumulate_pass(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                    criterion: Callable = F.cross_entropy,
                    factor_update: bool = False) -> tuple:
    """The forward and backward passes of one step on this rank's batch:
    ``(loss, acc, grads, captures, contribs)``.

    ``state.grad_accum == 1``: one pass; ``captures`` are its K-FAC
    captures on a factor step (``{}`` otherwise), ``contribs`` None.
    ``N > 1`` (the JAX accumulated step): :func:`micro_batches`, one pass
    each in turn; the losses, accuracies and gradients are summed and
    scaled by ``1/N``. On a K-FAC factor step each micro-batch's captures
    become its contributions (``local_factor_contribs``: K1 contraction
    only, K2) at once, summed in fp32; the sum is scaled by ``1/N``, and
    its output-grad-quadratic parts (``layers.GRAD_QUADRATIC_KEYS``: each
    micro-batch's output-grads come from its own mean loss, ``N`` times
    the batch mean's) by ``1/N^2`` more. ``captures`` is then ``{}`` and
    ``contribs`` the scaled sum (None off factor steps, where nothing is
    captured or contracted)."""
    do_factors = state.kfac is not None and bool(factor_update)
    n = state.grad_accum
    if n == 1:
        return (*_one_pass(state, x, y, criterion, do_factors), None)
    sums = contribs = None
    for xm, ym in micro_batches(x, y, n):
        loss, acc, grads, captures = _one_pass(state, xm, ym, criterion,
                                               do_factors)
        if do_factors:
            c = state.kfac.local_factor_contribs(captures)
            del captures
            if contribs is None:
                contribs = {name: {k: v.float() for k, v in e.items()}
                            for name, e in c.items()}
            else:
                for name, e in c.items():
                    for k, v in e.items():
                        contribs[name][k] += v
        if sums is None:
            sums = (loss.float(), acc, dict(grads))
        else:
            loss_s, acc_s, grads_s = sums
            for name, g in grads.items():
                grads_s[name] += g
            sums = (loss_s + loss, acc_s + acc, grads_s)
    inv_n = 1.0 / n
    loss_s, acc_s, grads_s = sums
    grads = {name: g * inv_n for name, g in grads_s.items()}
    if contribs is not None:
        g_fix = 1.0 / n ** 2
        contribs = {name: {k: ((g_fix * v) if k in GRAD_QUADRATIC_KEYS
                               else v) * inv_n for k, v in e.items()}
                    for name, e in contribs.items()}
    return loss_s * inv_n, acc_s * inv_n, grads, {}, contribs


def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
               hyper: dict, flags: dict,
               criterion: Callable = F.cross_entropy
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One forward/backward (``state.grad_accum`` micro-batches:
    :func:`accumulate_pass`), K-FAC preconditioning and SGD update, with
    the loss ``criterion(logits, labels)`` (default cross entropy).
    Returns the (device) loss and accuracy of the batch, averaged over
    the world when ``state.distributed``. Under ``state.loss_scale`` an
    overflowing step is skipped (:func:`_overflow_skip`)."""
    kfac = state.kfac
    buffers = _buffer_snapshot(state)
    loss, acc, grads, captures, contribs = accumulate_pass(
        state, x, y, criterion,
        factor_update=kfac is not None and flags['factor_update'])
    checked = _capture_check(state, captures or contribs)
    if state.distributed:
        *means, loss, acc = world_mean([*grads.values(), *checked, loss,
                                        acc])
        grads, checked = dict(zip(grads, means)), means[len(grads):]
    if buffers is not None and _overflow_skip(
            state, [*grads.values(), *checked], buffers):
        return loss, acc
    if kfac is not None:
        grads, state.kfac_state = kfac.step(
            state.kfac_state, grads, captures, contribs=contribs,
            damping=hyper.get('damping'), lr=hyper['lr'],
            **kfac_step_flags(flags), gates=hyper.get('bucket_gate'))
    for name, p in state.model.named_parameters():
        if name in grads:
            p.grad = grads[name]
    state.optimizer.step()
    if state.distributed:
        average_buffers(state.model)
    return loss, acc


def train_epoch(state: TrainState, batches: Iterable, hyper: dict, *,
                device, verbose: bool = False, time_steps: bool = False,
                max_steps: int | None = None,
                criterion: Callable = F.cross_entropy, checkpointer=None,
                start_step_in_epoch: int = 0, metrics_sink=None,
                observers: 'Observers | None' = None) -> dict:
    """One training epoch; returns the averaged metrics and, per step,
    the losses, the fired stage and (``time_steps``: each step
    synchronized) the wall milliseconds, and whether ``max_steps`` stopped
    it before its last batch (``stopped``).

    ``hyper`` holds this epoch's ``lr`` and, with K-FAC, ``damping`` and
    the update frequencies (``KFACParamScheduler.params()``). Stops after
    ``max_steps`` global steps when given. ``criterion`` is the training
    loss (see :func:`train_step`). ``checkpointer`` (a
    ``resilience.policy.StepCheckpointer``, or without step bundles the
    ``resilience.faults.StateFaults`` hook) is called after each step with
    the steps finished in the epoch, ``start_step_in_epoch`` (the
    mid-epoch resume offset) included; it may raise ``Preempted``, and the
    ladder (``observers.selfheal``) ``Rollback``, which then carry the
    epoch's record so far as ``partial`` (the sinks are flushed first).
    ``metrics_sink``: one step record per step and the epoch record;
    ``observers``: memory records, straggler shards and the ladder
    (module docstring).
    """
    device = torch.device(device)
    state.model.train()
    meters: dict[str, Metric] = {}
    losses, fired, step_ms = [], [], []
    scaler = [] if state.loss_scale is not None else None
    schedule = (epoch_schedule(state.kfac, hyper['inv_update_freq'])
                if state.kfac is not None else {})
    stopped = False
    epoch_cache: dict = {}
    t_epoch = time.perf_counter()
    try:
        for xb, yb in batches:
            if max_steps is not None and state.step >= max_steps:
                stopped = True
                break
            flags = (cadence_flags(state.step, hyper['factor_update_freq'],
                                   hyper['inv_update_freq'], **schedule)
                     if state.kfac is not None else {})
            if state.distributed:
                local = launch.process_local_slice(len(xb))
                xb, yb = xb[local], yb[local]
            x = torch.as_tensor(np.ascontiguousarray(xb), device=device)
            y = torch.as_tensor(yb, dtype=torch.long, device=device)
            wait_ms = _probe(observers, state.step)
            step_hyper = _step_hyper(observers, hyper)
            t0 = time.perf_counter()
            scale = state.loss_scale and state.loss_scale['scale']
            loss, acc = train_step(state, x, y, step_hyper, flags,
                                   criterion)
            dispatch_ms = (time.perf_counter() - t0) * 1e3
            if time_steps:
                if device.type == 'cuda':
                    torch.cuda.synchronize(device)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            if scaler is not None:
                scaler.append((scale, state.overflow))
            losses.append(loss)
            fired.append(fired_stage(flags))
            metrics = step_metrics(
                state, loss, acc, scale if metrics_sink is not None else None)
            for k, v in metrics.items():
                meters.setdefault(k, Metric(k)).update(v)
            _after_dispatch(state, metrics_sink, observers, metrics,
                            dispatch_ms, fired[-1], wait_ms, device,
                            epoch_cache)
            state.step += 1
            if checkpointer is not None:
                _after_step(checkpointer, state,
                            start_step_in_epoch + len(losses), metrics_sink,
                            observers)
    except (Preempted, Rollback) as p:
        p.partial = {'losses': [float(v) for v in losses], 'fired': fired,
                     'step_ms': step_ms if time_steps else None,
                     'scaler': _scaler_record(scaler)}
        raise
    out = {k: m.avg for k, m in meters.items()}
    if metrics_sink is not None and losses:
        record_epoch(metrics_sink, state.epoch, out, len(losses),
                     time.perf_counter() - t_epoch)
    _flush_shard(observers)
    if verbose and out:
        shown = {k: round(v, 4) for k, v in out.items()
                 if not k.startswith('kfac/')}
        print(f'epoch {state.epoch}: train {shown}')
    return {'metrics': out, 'losses': [float(v) for v in losses],
            'fired': fired, 'step_ms': step_ms if time_steps else None,
            'scaler': _scaler_record(scaler), 'stopped': stopped}


@dataclasses.dataclass
class Observers:
    """A run's observers beside the metrics sink (module docstring); the
    defaults observe nothing. ``rank_sink``: this rank's straggler shard
    (``observability.stragglers.make_rank_shard_sink``);
    ``barrier_probe``: ``probe() -> wait_ms``, run on the steps
    ``sample_every`` selects; ``memory_interval``: steps between memory
    records (0: none); ``profile_dir``: the ``torch.profiler`` trace of
    the first trained epoch on rank ``rank``; ``selfheal``: a
    ``resilience.selfheal.SelfHealController``."""
    rank_sink: Any = None
    barrier_probe: Callable[[], float] | None = None
    sample_every: int = 1
    memory_interval: int = 0
    profile_dir: str | None = None
    rank: int = 0
    selfheal: Any = None

    def close(self) -> None:
        if self.rank_sink is not None:
            self.rank_sink.close()


def make_observers(args: argparse.Namespace, state: TrainState, sink,
                   device, *, cli: str, meta: dict | None = None
                   ) -> Observers:
    """The :class:`Observers` of a CLI run, made once the ``TrainState``
    exists: ``--memory-interval`` (with ``--kfac-metrics``),
    ``--straggler-shards`` (the rank's shard; with a K-FAC world, the
    barrier probe of its ``DistributedKFAC``; with more than one slice,
    the rank's slice in the shard's meta), ``--straggler-sample-every``,
    ``--profile-dir`` and ``--selfheal*`` (``resilience.cli.
    make_selfheal``)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    shard_meta = {'cli': cli, **(meta or {})}
    slices = getattr(args, 'num_slices', 1)
    if dist.is_initialized() and slices > 1:
        shard_meta['slice'] = multislice.slice_of_rank(
            rank, dist.get_world_size(), slices)
    rank_sink = obs_cli.make_rank_shard_sink(args, rank, meta=shard_meta)
    probe = (state.kfac.build_barrier_probe()
             if rank_sink is not None
             and hasattr(state.kfac, 'build_barrier_probe') else None)
    return Observers(
        rank_sink=rank_sink, barrier_probe=probe,
        sample_every=getattr(args, 'straggler_sample_every', 1),
        memory_interval=(getattr(args, 'memory_interval', 0)
                         if args.kfac_metrics else 0),
        profile_dir=getattr(args, 'profile_dir', None), rank=rank,
        selfheal=resilience_cli.make_selfheal(
            args, kfac=state.kfac, sink=sink, device=device))


def _probe(observers: Observers | None, step: int) -> float | None:
    """The barrier probe's wait (ms) at ``step`` when it samples it, else
    None; run before the step, so the wait is not this step's work."""
    if observers is None or observers.barrier_probe is None \
            or not obs_stragglers.sampled(step, observers.sample_every):
        return None
    return observers.barrier_probe()


def _step_hyper(observers: Observers | None, hyper: dict) -> dict:
    """The step's hyperparameters: the ladder's (escalated damping,
    quarantine gates) when it is armed, else ``hyper`` itself."""
    if observers is None or observers.selfheal is None:
        return hyper
    return observers.selfheal.adjust_hyper(hyper)


def _record_label(state: TrainState, fired: str | None) -> str | None:
    """The fired stage a step's records carry: under hierarchical
    reduction a window head's ``reduce`` is the cross-slice collective,
    ``dcn_reduce``."""
    kfac = getattr(state.kfac, 'kfac', state.kfac)
    if fired and 'reduce' in fired and getattr(kfac, 'hierarchical_reduce',
                                               False):
        return fired.replace('reduce', 'dcn_reduce')
    return fired


def _after_dispatch(state: TrainState, sink, observers: Observers | None,
                    metrics: dict, dispatch_ms: float, fired: str | None,
                    wait_ms: float | None, device, epoch_cache: dict
                    ) -> None:
    """Everything that follows a step's dispatch (``state.step`` still
    the step just run): its record with the pending kernel-build events
    and its host time in the trace table, a memory record every
    ``memory_interval`` steps, the rank's shard record and the ladder's
    observation (on :class:`Rollback` the sinks are flushed first)."""
    label = _record_label(state, fired)
    if sink is not None:
        label = record_step(sink, state.step, metrics, dispatch_ms, label)
        tracing.record('train_step_dispatch', dispatch_ms / 1e3)
    if observers is None:
        return
    if sink is not None and observers.memory_interval > 0 \
            and state.step % observers.memory_interval == 0:
        if 'footprint' not in epoch_cache:
            epoch_cache['footprint'] = obs_memory.state_footprint(
                state.kfac_state)
        sink.memory_record(state.step,
                           device=obs_memory.device_memory_stats(device),
                           state=epoch_cache['footprint'])
    if observers.rank_sink is not None:
        shard = ({} if wait_ms is None
                 else {obs_stragglers.BARRIER_WAIT_KEY: wait_ms})
        observers.rank_sink.step_record(state.step, shard,
                                        host_step_ms=dispatch_ms,
                                        fired=label)
    ladder = observers.selfheal
    if ladder is not None:
        try:
            ladder.observe(state, metrics)
        except BaseException:
            _drain_selfheal(ladder, sink)
            if sink is not None:
                sink.flush()
            _flush_shard(observers)
            raise
        _drain_selfheal(ladder, sink)


def _drain_selfheal(ladder, sink) -> None:
    """The ladder's queued decision events into ``sink`` (kept queued
    without one)."""
    if sink is None:
        return
    for ev in ladder.drain_events():
        sink.event_record(ev['event'], **{k: v for k, v in ev.items()
                                          if k != 'event'})


def _flush_shard(observers: Observers | None) -> None:
    if observers is not None and observers.rank_sink is not None:
        observers.rank_sink.flush()


def step_metrics(state: TrainState, loss, acc=None, scale=None) -> dict:
    """The step's metrics, as the JAX step returns them: ``loss`` (and
    ``acc``), with ``scale`` (the dynamic loss scale the step used; the
    epoch loops pass it when a sink records the step) ``loss_scale`` and
    ``overflow`` (1.0 for a skipped step), and under
    ``collect_metrics`` the K-FAC state's metrics flattened to ``kfac/*``
    (an overflow-skipped step leaves them as they were). Device scalars
    stay on the device."""
    out = {'loss': loss}
    if acc is not None:
        out['acc'] = acc
    if scale is not None:
        out['loss_scale'] = scale
        out['overflow'] = 1.0 if state.overflow else 0.0
    kst = state.kfac_state
    if kst is not None and 'metrics' in kst:
        out.update(obs_metrics.flatten_metrics(kst['metrics']))
    return out


def record_step(sink, step: int, metrics: dict, dispatch_ms: float,
                fired: str | None) -> str | None:
    """One step record into ``sink``, then the pending kernel-build events
    (``compile``; a plain step that built the kernels is labelled
    ``'compile'``). Returns the label recorded."""
    events = kernels.drain_build_events()
    if events and fired is None:
        fired = 'compile'
    sink.step_record(step, metrics, host_step_ms=dispatch_ms, fired=fired)
    for ev in events:
        sink.event_record(ev['event'], **{k: v for k, v in ev.items()
                                          if k != 'event'})
    return fired


def record_epoch(sink, epoch: int, averages: dict, steps: int,
                 seconds: float) -> None:
    """The epoch record (the averages with ``time_s`` and ``ms_per_iter``,
    and the trace table's snapshot, as the JAX engine writes them), then a
    flush."""
    sink.epoch_record(epoch, {**averages, 'time_s': seconds,
                              'ms_per_iter': seconds / steps * 1000.0},
                      trace=tracing.snapshot_trace())
    sink.flush()


def _after_step(checkpointer, state: TrainState, step_in_epoch: int,
                sink, observers: Observers | None = None) -> None:
    """``checkpointer.after_step``; when it raises (a preemption drain),
    the sinks are flushed first, so the steps done so far are on disk
    beside the bundle the relaunch resumes from."""
    try:
        checkpointer.after_step(state, step_in_epoch)
    except BaseException:
        if sink is not None:
            sink.flush()
        _flush_shard(observers)
        raise


def _scaler_record(scaler: list | None) -> list | None:
    """Per step, ``{'scale', 'overflow'}``: the loss scale the step used
    and whether it was skipped (None without a dynamic loss scale)."""
    if scaler is None:
        return None
    return [{'scale': float(s), 'overflow': bool(o)} for s, o in scaler]


def fit(state: TrainState, train_data, val_data, *, lr_schedule,
        kfac_sched, epochs: int, batch_size: int, val_batch_size: int,
        seed: int, augment: bool, device, max_steps: int | None = None,
        time_steps: bool = False, verbose: bool = False,
        criterion: Callable = F.cross_entropy,
        ckpt: 'Checkpointing | None' = None,
        precise_bn: Callable[[int], Iterable] | None = None,
        metrics_sink=None, log_writer=None,
        observers: Observers | None = None) -> dict:
    """The CLIs' epoch loop: per epoch, set the LR, train on the
    reshuffled ``(x, y)`` arrays of ``train_data`` (augmented with
    ``augment``), evaluate on ``val_data`` and advance the K-FAC
    scheduler; stop after ``max_steps`` global steps when given.

    ``precise_bn(epoch)``: the batches :func:`precise_bn_recalibrate`
    re-estimates the BatchNorm statistics over before each evaluation;
    the evaluation reads them, and the training statistics are restored
    after it, so the training state (and a checkpoint) is unchanged.

    With ``ckpt`` (:func:`start_checkpointing`) the loop starts at its
    resume point (``start_epoch``, skipping ``start_offset`` batches of
    that epoch), checkpoints each step through its ``StepCheckpointer``,
    polls for preemption between epochs and saves the epoch bundle every
    ``freq`` epochs and after the last; a preemption ends the loop.

    The batch consumed at the ``KFAC_CHAOS`` plan's ``nan-batch`` step is
    poisoned (``resilience.faults.poison_at``). ``metrics_sink`` and
    ``log_writer`` (a :class:`TensorBoardWriter`) take the step and epoch
    records, and ``observers`` observe the run (module docstring); a
    self-healing rollback restores in place and the loop goes on.

    Returns ``{'device', 'steps', 'losses', 'fired', 'step_ms', 'scaler',
    'train', 'val', 'seconds', 'state', 'preempted'}``: per-step losses
    and fired stages (:func:`fired_stage`) of the steps this call ran,
    per-step wall ms when ``time_steps``, under a dynamic loss scale the
    per-step ``{'scale', 'overflow'}`` (else None), the last epoch's
    train / val metrics, the final ``TrainState``, after a
    preemption its ``global_step`` and ``reason`` (else None), and the
    self-healing rollbacks (``rollbacks``: ``from_step``, ``to_step``).
    """
    device = torch.device(device)
    plan = faults.plan_from_env()
    hook = faults.StateFaults(plan)     # without step checkpoints

    def epoch_fn(epoch: int, skip: int, hyper: dict) -> dict:
        batches = faults.poison_at(
            datasets.epoch_batches(*train_data, batch_size, seed=seed,
                                   epoch=epoch, augment=augment,
                                   skip_batches=skip),
            plan, first_step=state.step)
        return train_epoch(state, batches, hyper, device=device,
                           verbose=verbose, time_steps=time_steps,
                           max_steps=max_steps, criterion=criterion,
                           checkpointer=ckpt.step_ckpt if ckpt else hook,
                           start_step_in_epoch=skip,
                           metrics_sink=metrics_sink, observers=observers)

    def eval_fn(epoch: int) -> dict:
        saved = (precise_bn_recalibrate(
            state.model, precise_bn(epoch), device=device,
            distributed=state.distributed) if precise_bn else {})
        try:
            return evaluate(
                state.model, datasets.epoch_batches(
                    *val_data, val_batch_size, shuffle=False),
                device=device, epoch=epoch, verbose=verbose)
        finally:
            restore_buffers(state.model, saved)

    return _epoch_loop(state, epoch_fn, eval_fn, lr_schedule=lr_schedule,
                       kfac_sched=kfac_sched, epochs=epochs,
                       max_steps=max_steps, time_steps=time_steps,
                       verbose=verbose, device=device, ckpt=ckpt,
                       metrics_sink=metrics_sink, log_writer=log_writer,
                       observers=observers)


def _epoch_loop(state: TrainState, epoch_fn, eval_fn, *, lr_schedule,
                kfac_sched, epochs: int, max_steps: int | None,
                time_steps: bool, verbose: bool, device,
                ckpt: 'Checkpointing | None', metrics_sink=None,
                log_writer=None, observers: Observers | None = None) -> dict:
    """The epoch loop :func:`fit` and :func:`fit_lm` share:
    ``epoch_fn(epoch, skip, hyper)`` trains one epoch (a
    :func:`train_epoch` result), ``eval_fn(epoch)`` evaluates; the epoch's
    train and validation averages go to ``log_writer``, and a preemption
    flushes ``metrics_sink``. The first epoch trained is profiled under
    ``observers.profile_dir``; a self-healing :class:`Rollback` restores
    the newest verified, finite step bundle before the fault
    (``resilience.selfheal.handle_rollback``) and the loop continues from
    its epoch and offset."""
    losses, fired, step_ms = [], [], []
    scaler = [] if state.loss_scale is not None else None
    train_m = val_m = {}
    preempted = None
    rollbacks = []
    obs = observers or Observers()
    profile_dir = obs.profile_dir
    start_epoch, start_offset = ((ckpt.start_epoch, ckpt.start_offset)
                                 if ckpt else (0, 0))

    def extend(part: dict) -> None:
        nonlocal losses, fired, step_ms, scaler
        losses += part['losses']
        fired += part['fired']
        if time_steps:
            step_ms += part['step_ms']
        if scaler is not None:
            scaler += part['scaler']

    t_start = time.perf_counter()
    try:
        epoch = start_epoch
        while epoch < epochs:
            if max_steps is not None and state.step >= max_steps:
                break
            skip = start_offset if epoch == start_epoch else 0
            state.epoch = epoch
            if ckpt:
                # A notice that landed during the last evaluation or
                # epoch save drains here, with the mid-epoch offset.
                ckpt.step_ckpt.poll(state, skip)
            lr = lr_schedule(epoch)
            optimizers.set_lr(state.optimizer, lr)
            hyper = {'lr': lr,
                     **(kfac_sched.params() if kfac_sched else {})}
            try:
                with obs_cli.profile_epoch(profile_dir, obs.rank):
                    profile_dir = None      # the first epoch trained only
                    res = epoch_fn(epoch, skip, hyper)
            except Rollback as rb:
                extend(rb.partial)
                start_epoch, start_offset = handle_rollback(
                    rb, ckpt=ckpt, state=state, controller=obs.selfheal,
                    sink=metrics_sink, device=device, verbose=verbose)
                rollbacks.append({'from_step': rb.global_step,
                                  'to_step': state.step})
                epoch = start_epoch
                continue
            train_m = res['metrics'] or train_m
            extend(res)
            val_m = eval_fn(epoch)
            if log_writer is not None:
                log_writer.epoch(epoch, res['metrics'], val_m)
            if kfac_sched:
                kfac_sched.step(epoch + 1)
            # An epoch resumed at its end yields no batch and is done.
            state.epoch = epoch + 1
            if ckpt and not res['stopped']:
                ckpt.after_epoch(state, epoch, epochs)
            epoch += 1
    except Preempted as p:
        extend(p.partial)
        preempted = {'global_step': p.global_step, 'reason': p.reason}
        if metrics_sink is not None:
            metrics_sink.flush()
        _flush_shard(obs)
        if verbose:
            print(f'preempted ({p.reason}) at global step '
                  f'{p.global_step}; checkpoint saved — exiting '
                  f'{RELAUNCH_EXIT_CODE} for relaunch', flush=True)
    seconds = time.perf_counter() - t_start
    if verbose and preempted is None:
        print(f'total: {seconds:.1f}s')
    return {'device': str(device), 'steps': state.step, 'losses': losses,
            'fired': fired, 'step_ms': step_ms if time_steps else None,
            'scaler': scaler, 'train': train_m, 'val': val_m,
            'seconds': seconds, 'state': state, 'preempted': preempted,
            'rollbacks': rollbacks}


def add_distributed_args(p: argparse.ArgumentParser) -> None:
    """The image CLIs' distribution flags (the JAX CLIs' names)."""
    p.add_argument('--warmup-epochs', type=float, default=5,
                   help='epochs of LR warm-up to world-size x base lr')
    p.add_argument('--comm-method', default='comm-opt',
                   choices=sorted(optimizers.COMM_METHODS))
    p.add_argument('--grad-worker-fraction', type=float, default=0.25)
    p.add_argument('--coallocate-layer-factors', action='store_true',
                   help='decompose A and G of a layer on the same rank')
    p.add_argument('--symmetry-aware-comm', action='store_true',
                   help='triangle-packed factor all_reduce (about half '
                        'the bytes)')
    p.add_argument('--grad-accum', type=int, default=1,
                   help='micro-batches per step (the reference '
                        '--batches-per-allreduce): each rank runs its '
                        'batch slice as this many micro-batches in turn')
    add_fp16_arg(p)
    add_num_slices_arg(p)


def add_fp16_arg(p: argparse.ArgumentParser) -> None:
    """``--fp16`` (all three CLIs, the JAX name): fp16 model compute with
    the dynamic loss scale and the overflow skip."""
    p.add_argument('--fp16', action='store_true',
                   help='fp16 model compute (parameters and norm '
                        'statistics fp32) with dynamic loss scaling and '
                        'the overflow skip (GradScaler parity, reference '
                        'engine.py:38-41,75-80; the reference ImageNet '
                        'launch passes --fp16, '
                        'launch_node_torch_imagenet.sh:73-87)')


def compute_dtype(args: argparse.Namespace) -> torch.dtype:
    """The model's compute dtype a CLI's flags ask for: fp16 under
    ``--fp16``, else fp32."""
    return torch.float16 if args.fp16 else torch.float32


def add_precision_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLIs' reduced-precision flags (all three CLIs), read by
    :func:`precision_config`."""
    p.add_argument('--bf16-factors', action='store_true',
                   help='bf16 factor storage/averaging + bf16 covariance '
                        'matmul inputs (matmuls accumulate fp32); the '
                        'reference fp16 factor mode')
    p.add_argument('--bf16-inverses', action='store_true',
                   help='bf16 inverse storage (decompositions stay '
                        'fp32); halves the K-FAC inverse state')
    p.add_argument('--bf16-precond', action='store_true',
                   help='bf16 precondition-contraction operands (fp32 '
                        'accumulation; KFAC precond_compute_dtype); with '
                        '--bf16-inverses the stored inverses are read as '
                        'they are stored')


def add_schedule_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLIs' firing-schedule flags (all three CLIs), read by
    :func:`schedule_config`."""
    p.add_argument('--inv-pipeline-chunks', type=int, default=1,
                   help='pipeline the per-firing inverse work into K '
                        'cost-balanced chunks fired across the cadence '
                        'window (step-time uniformity); 1 = reference '
                        'parity (monolithic firing). K must divide '
                        "--kfac-update-freq and not exceed the model's "
                        'inverse work items')
    p.add_argument('--deferred-factor-reduction', action='store_true',
                   help='accumulate factor statistics locally and '
                        'reduce across replicas once per cadence window '
                        'instead of every factor step (exact by EMA '
                        'linearity; off keeps the eager per-step '
                        'reduction)')
    p.add_argument('--inv-staleness', type=int, default=0, choices=[0, 1],
                   help='1 = one-window-stale inverses: decompositions '
                        "fire across the window's plain steps from the "
                        'frozen window-head factor snapshot (needs '
                        '--kfac-update-freq / --inv-pipeline-chunks >= 2)')
    p.add_argument('--factor-batch-fraction', type=float, default=1.0,
                   help='fraction of the batch used for factor '
                        'statistics (1.0 = reference parity; <1 thins '
                        'the covariance sample within the step)')
    p.add_argument('--hierarchical-reduce', action='store_true',
                   help='two-level factor reduction (requires '
                        '--num-slices > 1, mutually exclusive with '
                        '--deferred-factor-reduction): a mean within '
                        'each slice every factor step, one mean across '
                        'slices per cadence window')
    p.add_argument('--inv-lowrank-rank', type=int, default=0,
                   help='rank of the randomized truncated '
                        'eigendecomposition for large factor dims: dims '
                        '>= --inv-lowrank-dim-threshold fire a rank-r '
                        'warm subspace step + polish (r*d^2 work) '
                        'instead of the O(d^3) exact decomposition; '
                        'preconditioning adds the damping-only tail '
                        'complement. 0 (default) = off; rank >= an '
                        'engaged dim is an error')
    p.add_argument('--inv-lowrank-dim-threshold', type=int, default=2048,
                   help='smallest dense factor dim the low-rank path '
                        'engages (ignored at --inv-lowrank-rank 0)')


def schedule_config(args: argparse.Namespace) -> dict:
    """The ``OptimConfig`` fields of :func:`add_schedule_args`' flags."""
    return {key: getattr(args, key) for key in
            ('inv_pipeline_chunks', 'deferred_factor_reduction',
             'inv_staleness', 'factor_batch_fraction',
             'hierarchical_reduce', 'inv_lowrank_rank',
             'inv_lowrank_dim_threshold')}


def add_num_slices_arg(p: argparse.ArgumentParser) -> None:
    """``--num-slices`` (all three CLIs, the JAX name and default)."""
    p.add_argument('--num-slices', type=int,
                   default=int(os.environ.get('KFAC_NUM_SLICES', 1)),
                   help='multi-slice world: N contiguous slices of the '
                        'ranks, each with its own K-FAC grid (1, the '
                        'default, is the flat world); must divide the '
                        'process count. Defaults from KFAC_NUM_SLICES')


def observability_config(args: argparse.Namespace) -> dict:
    """The ``OptimConfig`` fields of the metrics flags: the on-device
    metrics under ``--kfac-metrics``, the non-finite factor guard under
    ``--health-action skip|raise`` or ``--selfheal`` (the ladder's first
    rung)."""
    return {'kfac_metrics': bool(args.kfac_metrics),
            'nonfinite_guard': (obs_cli.wants_guard(args)
                                or resilience_cli.wants_selfheal_guard(
                                    args))}


def precision_config(args: argparse.Namespace) -> dict:
    """The ``OptimConfig`` fields of :func:`add_precision_args`' flags."""
    return {key: getattr(args, key) for key in
            ('bf16_factors', 'bf16_inverses', 'bf16_precond')}


#: Flags of the JAX CLIs the port does not run yet, by destination, with
#: their argparse definitions (the JAX names and "off" defaults; a path
#: flag is off at None): autotune and heartbeats.
_UNPORTED_ARGS = {
    'tuned_config': {},
    'cadence_backoff': {'action': 'store_true'},
    'backoff_skew_ms': {'type': float, 'default': 5.0},
    'backoff_sustain_steps': {'type': int, 'default': 8},
    'backoff_recover_steps': {'type': int, 'default': 32},
    'backoff_max_stretch': {'type': int, 'default': 4},
    'heartbeat_dir': {},
    'heartbeat_every': {'type': int, 'default': 1},
}


def _off(spec: dict):
    return spec.get('default', False if spec.get('action') else None)


#: Every flag the port does not run yet, with its "off" value
#: (:data:`_UNPORTED_ARGS`).
UNPORTED_FLAGS = tuple((k, _off(v)) for k, v in _UNPORTED_ARGS.items())


def add_unported_args(p: argparse.ArgumentParser) -> None:
    """The :data:`_UNPORTED_ARGS` flags, each raising by name when set
    (:func:`check_unported`)."""
    for dest, spec in _UNPORTED_ARGS.items():
        p.add_argument('--' + dest.replace('_', '-'), **spec,
                       help='not ported (raises when set)')


def check_unported(args: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` naming any unported flag that is set
    (flags the CLI does not have are skipped), or any ``KFAC_CHAOS`` fault
    kind the port does not inject."""
    for flag, off in UNPORTED_FLAGS:
        if getattr(args, flag, off) != off:
            raise NotImplementedError(
                f'--{flag.replace("_", "-")} is not ported to torch yet')
    faults.check_ported(faults.plan_from_env())


def add_observability_args(p: argparse.ArgumentParser, name: str) -> None:
    """``--log-dir`` (the JAX CLIs' default ``./logs/<name>``) and the
    metrics flags of ``observability.cli.add_observability_args``."""
    p.add_argument('--log-dir', default=f'./logs/{name}',
                   help='TensorBoard scalars (where the tensorboard '
                        'package is installed) and the default '
                        '--kfac-metrics directory')
    obs_cli.add_observability_args(p)


def start_observability(args: argparse.Namespace, cli: str,
                        meta: dict) -> tuple:
    """``(metrics_sink, log_writer)`` of a CLI run, made before the model
    (either may be None): the JSONL sink of ``--kfac-metrics`` (rank 0
    writes; its leading meta record is ``{'cli': cli, **meta,
    'metrics_interval'}``) and, on rank 0 with a ``--log-dir``, the
    :class:`TensorBoardWriter`. ``--kfac-metrics`` without the K-FAC step
    raises the JAX CLIs' ``SystemExit``."""
    if args.kfac_metrics and args.kfac_update_freq <= 0:
        raise SystemExit('--kfac-metrics requires the K-FAC step '
                         '(--kfac-update-freq > 0)')
    rank = dist.get_rank() if dist.is_initialized() else 0
    sink = obs_cli.make_metrics_sink(
        args, rank, meta={'cli': cli, **meta,
                          'metrics_interval': args.metrics_interval})
    writer = (TensorBoardWriter(args.log_dir)
              if args.log_dir and rank == 0 else None)
    return sink, writer


def close_observability(sink, writer,
                        observers: Observers | None = None) -> None:
    """Flush and close what :func:`start_observability` and
    :func:`make_observers` made."""
    if observers is not None:
        observers.close()
    if sink is not None:
        sink.close()
    if writer is not None:
        writer.close()


def add_port_args(p: argparse.ArgumentParser) -> None:
    """The port-only flags every CLI takes: ``--device``, ``--dist-backend``
    and ``--deterministic``, ``--max-steps``, ``--time-steps``,
    ``--quiet`` and ``--launch-counts``."""
    p.add_argument('--device', default='cuda')
    p.add_argument('--dist-backend', default=None, choices=['nccl', 'gloo'],
                   help='process-group backend under a launcher (default: '
                        'nccl on CUDA, gloo on the CPU; gloo on CUDA runs '
                        'several ranks on one card)')
    p.add_argument('--deterministic', action='store_true',
                   help='deterministic cuDNN convolutions: a rerun, or a '
                        'resumed run, equals the uninterrupted run bit '
                        'for bit on the card')
    p.add_argument('--max-steps', type=int, default=None)
    p.add_argument('--time-steps', action='store_true')
    p.add_argument('--quiet', action='store_true')
    p.add_argument('--launch-counts', default=None, metavar='PATH',
                   help="write the kernels' launch counts of this process "
                        '(ops.kernels.LAUNCHES) to PATH as JSON when the '
                        'run ends; {rank} in PATH is the process rank')


def start_world(device, backend: str | None = None) -> int:
    """Join the world a launcher declared (``torchrun``'s environment)
    unless a process group is already up; returns its size (1 when the
    process is alone). ``backend`` as in
    ``launch.initialize_distributed``."""
    launch.initialize_distributed(device=device, backend=backend)
    return dist.get_world_size() if dist.is_initialized() else 1


def add_precise_bn_arg(p: argparse.ArgumentParser) -> None:
    """The image CLIs' ``--precise-bn-batches`` (the JAX CLIs' flag)."""
    p.add_argument('--precise-bn-batches', type=int, default=0,
                   help='re-estimate BN running statistics over this '
                        'many forward-only train batches before each '
                        'eval (precise-BN; 0 = off). Eval-only: the '
                        'training statistics are restored afterwards.')


def precise_bn_batches(args: argparse.Namespace, model: torch.nn.Module,
                       batches_of: Callable[[int], Iterable]
                       ) -> Callable[[int], Iterable] | None:
    """:func:`fit`'s ``precise_bn`` for ``--precise-bn-batches N``: the
    first ``N`` of ``batches_of(epoch)``; None when ``N`` is 0. A model
    without BatchNorm raises the JAX CLIs' ``SystemExit``."""
    n = args.precise_bn_batches
    if n <= 0:
        return None
    if not _batchnorms(model):
        raise SystemExit('--precise-bn-batches requires a BatchNorm '
                         f'model; {args.model!r} has no batch_stats')
    import itertools
    return lambda epoch: itertools.islice(batches_of(epoch), n)


def set_determinism(args: argparse.Namespace) -> None:
    """``--deterministic``: cuDNN's deterministic algorithms, no
    autotuning."""
    if getattr(args, 'deterministic', False):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def install_preemption(args: argparse.Namespace
                       ) -> PreemptionHandler | None:
    """The preemption handler of a checkpointed run (None when
    ``--checkpoint-dir`` is None); the caller uninstalls it when the run
    ends."""
    if getattr(args, 'checkpoint_dir', None) is None:
        return None
    return resilience_cli.install_preemption(args)


def finish_run(args: argparse.Namespace,
               preemption: PreemptionHandler | None) -> None:
    """The end of a CLI's run, however it ends: the preemption handler
    uninstalled and, with ``--launch-counts``, the launch counts
    written."""
    if preemption is not None:
        preemption.uninstall()
    if getattr(args, 'launch_counts', None):
        import json

        from distributed_kfac_pytorch_tpu_torch.ops import kernels
        rank = dist.get_rank() if dist.is_initialized() else 0
        with open(args.launch_counts.format(rank=rank), 'w') as f:
            json.dump(dict(kernels.LAUNCHES), f)


@dataclasses.dataclass
class Checkpointing:
    """A run's checkpoint wiring (:func:`start_checkpointing`): the epoch
    bundles' manager, the per-step hook, the bundle builder, the epoch
    frequency and the resume point."""
    epoch_mgr: checkpoint.CheckpointManager
    step_ckpt: Any
    bundle_fn: Callable
    freq: int
    start_epoch: int = 0
    start_offset: int = 0
    #: ``load(state, tree) -> (epoch, step_in_epoch)``: a restored bundle
    #: into the live state (the resume's and the rollback's loader).
    load: Callable | None = None

    def after_epoch(self, state: TrainState, epoch: int,
                    epochs: int) -> None:
        """Save the epoch bundle every ``freq`` epochs and after the last
        (replacing a bundle at that label)."""
        if (epoch + 1) % self.freq == 0 or epoch == epochs - 1:
            self.epoch_mgr.save(epoch, self.bundle_fn(state, 0), force=True)


def start_checkpointing(args: argparse.Namespace, state: TrainState,
                        kfac_sched, *, name: str, device,
                        preemption: PreemptionHandler | None,
                        extra_state: Callable[[], dict] | None = None,
                        load_extra: Callable[[dict], None] | None = None,
                        verbose: bool = False,
                        sink=None) -> Checkpointing | None:
    """The JAX CLIs' checkpoint wiring, shared by the three CLIs: None
    when ``--checkpoint-dir`` is None; else the epoch manager under
    ``--checkpoint-dir`` (``-sgd`` appended to the default directory
    without K-FAC), the step manager under its ``steps/``, the bundle
    builder and the resume (unless ``--no-resume``) into ``state``.

    A bundle holds the model's ``state_dict()`` (buffers included), the
    optimizer's (momentum), the K-FAC state with its inverses and bases
    (``include_inverses=True``), the K-FAC scheduler, ``extra_state()``
    (an LM's dropout generator state) and, under a dynamic loss scale, its
    state (``extra_vars['loss_scale']``, as the JAX CLIs keep it) and the
    resume scalars, with the digest field unhashed (the manager hashes
    each file it writes). On resume every part is loaded onto ``device``
    (``load_extra`` takes the ``extra_vars``; the loss-scale state goes
    back into ``state``, so the schedule continues bit for bit) and the
    scheduler steps to the resumed epoch. ``sink`` (a metrics sink) takes
    the ``restore``, ``ckpt_quarantine``, ``checkpoint_save`` and
    ``preemption`` events.
    """
    if args.checkpoint_dir is None:
        return None
    if state.kfac is None and args.checkpoint_dir == f'./checkpoints/{name}':
        # Keep the SGD comparison's bundles apart from a K-FAC run's.
        args.checkpoint_dir += '-sgd'
    epoch_mgr = checkpoint.CheckpointManager(args.checkpoint_dir)
    step_mgr = resilience_cli.make_step_manager(args)

    def bundle_fn(st: TrainState, step_in_epoch: int) -> dict:
        kfac_sd = (st.kfac.state_dict(st.kfac_state, include_inverses=True)
                   if st.kfac is not None else {})
        extra = dict(extra_state()) if extra_state else {}
        if st.loss_scale is not None:
            extra['loss_scale'] = dict(st.loss_scale)
        return checkpoint.bundle_state(
            st.model.state_dict(), st.optimizer.state_dict(), kfac_sd,
            extra,
            schedulers={'kfac': kfac_sched} if kfac_sched else None,
            integrity='template', step=st.step, epoch=st.epoch,
            step_in_epoch=int(step_in_epoch), data_seed=args.seed)

    def load(st: TrainState, tree: dict) -> tuple[int, int]:
        sc = tree['scalars']
        epoch = int(sc['epoch'])
        st.model.load_state_dict(tree['params'])
        st.optimizer.load_state_dict(tree['opt_state'])
        if st.kfac is not None:
            st.kfac_state = st.kfac.load_state_dict(tree['kfac'])
        if kfac_sched:
            kfac_sched.step(epoch)
        if load_extra is not None:
            load_extra(tree['extra_vars'])
        saved_scale = tree['extra_vars'].get('loss_scale')
        if st.loss_scale is not None and saved_scale is not None:
            st.loss_scale = {k: torch.as_tensor(v).to(device)
                             for k, v in saved_scale.items()}
        st.step = int(sc['step'])
        st.epoch = epoch
        return epoch, int(sc['step_in_epoch'])

    start_epoch = start_offset = 0
    resumed = resilience_cli.resume(args, epoch_mgr, step_mgr,
                                    device=device, verbose=verbose,
                                    sink=sink)
    if resumed is not None:
        start_epoch, start_offset = load(state, resumed[0])
    step_ckpt = resilience_cli.make_step_checkpointer(
        args, step_mgr, bundle_fn, preemption=preemption,
        start_step=state.step, verbose=verbose, sink=sink)
    return Checkpointing(epoch_mgr, step_ckpt, bundle_fn,
                         args.checkpoint_freq, start_epoch, start_offset,
                         load=load)


def make_train_state(model, optimizer, kfac, *,
                     coallocate_layer_factors: bool = False,
                     seq_parallel: int = 1,
                     num_slices: int = 1,
                     grad_accum: int = 1,
                     fp16: bool = False) -> TrainState:
    """The CLIs' ``TrainState``: with a process group up, data parallel
    over the world and ``kfac`` wrapped in ``DistributedKFAC`` (strategy
    from the ``KFAC``'s knobs; ``coallocate_layer_factors``: a layer's A
    and G on one rank; ``seq_parallel`` ranks per sequence group;
    ``num_slices`` contiguous slices, which must divide the process
    count, as the JAX CLIs' mesh requires); else the single-device
    ``KFAC``. ``grad_accum``: micro-batches per step
    (:func:`accumulate_pass`). ``fp16`` (``--fp16``): the dynamic loss
    scale, seeded with ``fp16.init_loss_scale()`` on the model's device;
    without K-FAC it raises the JAX CLIs' ``SystemExit``."""
    if grad_accum < 1:
        raise ValueError(f'grad_accum_steps={grad_accum} must be >= 1')
    if fp16 and kfac is None:
        raise SystemExit('--fp16 requires the K-FAC step '
                         '(--kfac-update-freq > 0); the SGD baseline path '
                         'does not wire the loss scaler.')
    distributed = dist.is_initialized()
    # Raises unless num_slices divides the process count.
    multislice.slice_rank_groups(
        dist.get_world_size() if distributed else 1, num_slices)
    if kfac is not None and distributed:
        from distributed_kfac_pytorch_tpu_torch.parallel.distributed import (
            DistributedKFAC,
        )
        kfac = DistributedKFAC(kfac, distribute_layer_factors=(
            False if coallocate_layer_factors else None),
            seq_parallel=seq_parallel, num_slices=num_slices)
    return TrainState(
        model=model, optimizer=optimizer, kfac=kfac,
        kfac_state=kfac.init_state() if kfac is not None else None,
        distributed=distributed, grad_accum=int(grad_accum),
        loss_scale=(fp16_lib.init_loss_scale(
            device=next(model.parameters()).device) if fp16 else None))


def parse_args(parser: argparse.ArgumentParser,
               args_or_config) -> argparse.Namespace:
    """A CLI's options from an ``argparse.Namespace`` (as is), a list of
    CLI strings, a dict of option overrides or None (the defaults).

    A dict or None starts with checkpointing and the TensorBoard
    directory off (``checkpoint_dir`` and ``log_dir`` None) unless it sets
    them: a programmatic run writes and resumes no bundles and writes no
    event files unless asked to. The command line keeps the JAX CLIs'
    default directories."""
    if args_or_config is None:
        args_or_config = {}
    if isinstance(args_or_config, argparse.Namespace):
        return args_or_config
    if isinstance(args_or_config, dict):
        args = parser.parse_args([])
        for key in ('checkpoint_dir', 'log_dir'):
            if hasattr(args, key):
                setattr(args, key, None)
        for key, value in args_or_config.items():
            key = key.replace('-', '_')
            if not hasattr(args, key):
                raise ValueError(f'unknown train option {key!r}')
            setattr(args, key, value)
        return args
    return parser.parse_args(list(args_or_config))


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


def _batchnorms(model: torch.nn.Module) -> list:
    """The BatchNorm modules of ``model`` that keep running statistics."""
    return [m for m in model.modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats]


@torch.no_grad()
def precise_bn_recalibrate(model: torch.nn.Module, batches: Iterable, *,
                           device, distributed: bool = False
                           ) -> dict[str, torch.Tensor]:
    """Precise-BN (the JAX ``precise_bn_recalibrate``): set every
    BatchNorm's running mean and variance to the plain average of its
    per-batch statistics over ``batches``, at the current weights,
    forward only (training-mode normalization, no gradient, so the K-FAC
    capture records nothing). With ``distributed`` each rank forwards its
    ``launch.process_local_slice`` of a batch and the batch's statistics
    are averaged over the world (JAX: the ``pmean`` over the K-FAC axes).

    The variance is torch's unbiased batch variance (the port's running
    variance; JAX averages the biased one): with ``n = B*H*W`` values per
    channel on a rank, the result is JAX's times ``n / (n - 1)``.

    Returns every buffer of the model as it was (the training EWMA and
    counters) for :func:`restore_buffers`; the BatchNorms' counters and
    momenta are left as they were. A model with no BatchNorm is left
    unchanged (``{}``); zero batches raise ``ValueError``."""
    bns = _batchnorms(model)
    if not bns:
        return {}
    device = torch.device(device)
    saved = {k: b.clone() for k, b in model.named_buffers()}
    momenta, was_training = [m.momentum for m in bns], model.training
    model.train()
    total, n = None, 0
    try:
        for m in bns:
            # new = (1 - 1) * old + 1 * batch statistic: the statistic.
            m.momentum = 1.0
        for xb, _ in batches:
            if distributed:
                xb = xb[launch.process_local_slice(len(xb))]
            model(torch.as_tensor(np.ascontiguousarray(xb), device=device))
            stats = [t for m in bns for t in (m.running_mean, m.running_var)]
            if distributed:
                stats = world_mean(stats)
            total = ([t.clone() for t in stats] if total is None
                     else torch._foreach_add(total, stats))
            n += 1
    finally:
        for m, momentum in zip(bns, momenta):
            m.momentum = momentum
        model.train(was_training)
    if n == 0:
        restore_buffers(model, saved)
        raise ValueError('precise_bn_recalibrate: zero batches provided')
    names = {id(b): k for k, b in model.named_buffers()}
    for m in bns:
        m.num_batches_tracked.copy_(saved[names[id(m.num_batches_tracked)]])
    means = torch._foreach_div(total, float(n))
    torch._foreach_copy_([t for m in bns
                          for t in (m.running_mean, m.running_var)], means)
    return saved


@torch.no_grad()
def restore_buffers(model: torch.nn.Module,
                    saved: dict[str, torch.Tensor]) -> None:
    """Copy ``saved`` (``{buffer name: tensor}``, as
    :func:`precise_bn_recalibrate` returns) back into the model's
    buffers, bit for bit."""
    for name, b in model.named_buffers():
        if name in saved:
            b.copy_(saved[name])


# ---------------------------------------------------------------------------
# Language model (the JAX LM CLI's step)
# ---------------------------------------------------------------------------

def lm_loss(out, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy over every ``(batch, time)`` position of
    an LM's output: the LSTM's ``(logits, states)`` or the Transformer's
    bare logits tensor."""
    logits = out if isinstance(out, torch.Tensor) else out[0]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """``optax.clip_by_global_norm`` over a dict of gradients: unchanged
    while their global L2 norm is below ``max_norm``, else each becomes
    ``(g / norm) * max_norm`` (device tensors throughout: no host sync)."""
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                          for g in grads.values()))
    return {k: torch.where(norm < max_norm, g, (g / norm) * max_norm)
            for k, g in grads.items()}


def lm_train_step(state: TrainState, ids: torch.Tensor,
                  targets: torch.Tensor, hyper: dict, flags: dict, *,
                  grad_clip: float = 0.0,
                  generator: torch.Generator | None = None,
                  pos_offset: int = 0) -> torch.Tensor:
    """One LM step: forward from zero states (``generator`` draws the
    dropout masks; a Transformer's ``ids`` start at position
    ``pos_offset``), backward, with ``state.distributed`` the world's mean
    of the gradients and the loss, K-FAC preconditioning, then the
    global-norm clip at ``grad_clip`` (0: none) over every update, then
    the SGD update. Under ``state.loss_scale`` the gradients are unscaled
    before the clip and an overflowing step is skipped
    (:func:`_overflow_skip`). Returns the (device) loss."""
    model = state.model
    kwargs = {'dropout_generator': generator}
    if pos_offset:
        kwargs['pos_offset'] = pos_offset
    loss_fn = lambda out: lm_loss(out, targets)  # noqa: E731
    buffers = _buffer_snapshot(state)
    if state.kfac is None:
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model(ids, **kwargs))
        loss.backward()
        loss = loss.detach()
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        captures = {}
    else:
        loss, _, grads, captures = _kfac_pass(
            state, loss_fn, ids, flags['factor_update'], **kwargs)
    checked = _capture_check(state, captures)
    if state.distributed:
        *means, loss = world_mean([*grads.values(), *checked, loss])
        grads, checked = dict(zip(grads, means)), means[len(grads):]
    if buffers is not None and _overflow_skip(
            state, [*grads.values(), *checked], buffers):
        return loss
    if state.kfac is not None:
        grads, state.kfac_state = state.kfac.step(
            state.kfac_state, grads, captures,
            damping=hyper.get('damping'), lr=hyper['lr'],
            **kfac_step_flags(flags), gates=hyper.get('bucket_gate'))
    if grad_clip:
        grads = clip_by_global_norm(grads, grad_clip)
    for name, p in model.named_parameters():
        if name in grads:
            p.grad = grads[name]
    state.optimizer.step()
    return loss


@torch.no_grad()
def evaluate_lm(model: torch.nn.Module, batches: Iterable, *,
                device, distributed: bool = False,
                seq_parallel: int = 1) -> dict[str, float]:
    """Validation loss (mean over the windows, dropout off) and
    perplexity ``exp(min(loss, 20))``; with ``distributed``, each rank
    takes its K-FAC rank's slice of every window's sequences
    (``launch.process_local_tile`` under ``seq_parallel``), whole and
    without the ring (as the JAX CLI's evaluation twin), and the loss is
    the world's mean."""
    device = torch.device(device)
    model.eval()
    total, windows = torch.zeros((), device=device), 0
    for xb, yb in batches:
        if distributed:
            local, _ = launch.process_local_tile(len(xb), xb.shape[1],
                                                 seq_parallel)
            xb, yb = xb[local], yb[local]
        x = torch.as_tensor(xb, dtype=torch.long, device=device)
        y = torch.as_tensor(yb, dtype=torch.long, device=device)
        with whole_sequences(model):
            total += lm_loss(model(x), y)
        windows += 1
    if not windows:
        raise ValueError('evaluate_lm: no validation windows (the '
                         'validation stream is shorter than batch x bptt)')
    if distributed:
        (total,) = world_mean([total])
    loss = float(total) / windows
    return {'loss': loss, 'ppl': math.exp(min(loss, 20.0))}


def fit_lm(state: TrainState, train_ids: np.ndarray, val_ids: np.ndarray,
           *, lr_schedule, kfac_sched, epochs: int, batch_size: int,
           bptt: int, seed: int, device, grad_clip: float = 0.0,
           generator: torch.Generator | None = None,
           fixed_batch: bool = False, max_steps: int | None = None,
           time_steps: bool = False, verbose: bool = False,
           seq_parallel: int = 1,
           ckpt: 'Checkpointing | None' = None,
           metrics_sink=None, log_writer=None,
           observers: Observers | None = None) -> dict:
    """The LM CLI's epoch loop: per epoch, set the LR, train on the BPTT
    windows of ``train_ids`` (tracks offset per ``(seed, epoch)``; with
    ``fixed_batch`` every step takes epoch 0's first window instead;
    with ``state.distributed`` each rank its ``launch.process_local_tile``
    of the window under ``seq_parallel``), evaluate on ``val_ids`` and
    advance the K-FAC scheduler; stop after ``max_steps`` global steps
    when given. ``ckpt``, ``metrics_sink``, ``log_writer`` and
    ``observers`` as in :func:`fit`.

    Returns what :func:`fit` returns; ``train`` and ``val`` hold the last
    epoch's ``loss`` and ``ppl``.
    """
    device = torch.device(device)
    first = next(datasets.bptt_batches(train_ids, batch_size, bptt,
                                       shuffle_offset=True, seed=seed,
                                       epoch=0))
    last = {}
    plan = faults.plan_from_env()
    hook = faults.StateFaults(plan)     # without step checkpoints

    def epoch_fn(epoch: int, skip: int, hyper: dict) -> dict:
        windows = faults.poison_at(
            datasets.bptt_batches(train_ids, batch_size, bptt,
                                  shuffle_offset=True, seed=seed,
                                  epoch=epoch, skip_batches=skip),
            plan, first_step=state.step)
        res = lm_train_epoch(
            state, windows, hyper, device=device, grad_clip=grad_clip,
            generator=generator, first=first if fixed_batch else None,
            seq_parallel=seq_parallel, time_steps=time_steps,
            max_steps=max_steps,
            checkpointer=ckpt.step_ckpt if ckpt else hook,
            start_step_in_epoch=skip, metrics_sink=metrics_sink,
            observers=observers)
        last.update(res['metrics'])
        return res

    def eval_fn(epoch: int) -> dict:
        val_m = evaluate_lm(state.model, datasets.bptt_batches(
            val_ids, batch_size, bptt), device=device,
            distributed=state.distributed, seq_parallel=seq_parallel)
        if verbose:
            print(f'epoch {epoch}: train ppl '
                  f'{last.get("ppl", math.nan):.2f}, val ppl '
                  f'{val_m["ppl"]:.2f}')
        return val_m

    return _epoch_loop(state, epoch_fn, eval_fn, lr_schedule=lr_schedule,
                       kfac_sched=kfac_sched, epochs=epochs,
                       max_steps=max_steps, time_steps=time_steps,
                       verbose=verbose, device=device, ckpt=ckpt,
                       metrics_sink=metrics_sink, log_writer=log_writer,
                       observers=observers)


def lm_train_epoch(state: TrainState, windows: Iterable, hyper: dict, *,
                   device, grad_clip: float = 0.0,
                   generator: torch.Generator | None = None, first=None,
                   seq_parallel: int = 1, time_steps: bool = False,
                   max_steps: int | None = None, checkpointer=None,
                   start_step_in_epoch: int = 0, metrics_sink=None,
                   observers: Observers | None = None) -> dict:
    """One LM epoch over ``windows`` (each step on ``first`` instead when
    given): :func:`train_epoch`'s record, with ``metrics`` the epoch's
    mean ``loss`` and its ``ppl`` (empty without a step), and the averages
    of the other step metrics (:func:`step_metrics`)."""
    schedule = (epoch_schedule(state.kfac, hyper['inv_update_freq'])
                if state.kfac is not None else {})
    state.model.train()
    losses, fired, step_ms = [], [], []
    meters: dict[str, Metric] = {}
    scaler = [] if state.loss_scale is not None else None
    stopped = False
    epoch_cache: dict = {}
    t_epoch = time.perf_counter()
    try:
        for xb, yb in windows:
            if max_steps is not None and state.step >= max_steps:
                stopped = True
                break
            if first is not None:
                xb, yb = first
            offset = 0
            if state.distributed:
                rows, cols = launch.process_local_tile(
                    len(xb), xb.shape[1], seq_parallel)
                xb, yb, offset = xb[rows, cols], yb[rows, cols], cols.start
            flags = (cadence_flags(state.step, hyper['factor_update_freq'],
                                   hyper['inv_update_freq'], **schedule)
                     if state.kfac is not None else {})
            x = torch.as_tensor(xb, dtype=torch.long, device=device)
            y = torch.as_tensor(yb, dtype=torch.long, device=device)
            wait_ms = _probe(observers, state.step)
            step_hyper = _step_hyper(observers, hyper)
            t0 = time.perf_counter()
            scale = state.loss_scale and state.loss_scale['scale']
            loss = lm_train_step(state, x, y, step_hyper, flags,
                                 grad_clip=grad_clip, generator=generator,
                                 pos_offset=offset)
            dispatch_ms = (time.perf_counter() - t0) * 1e3
            if time_steps:
                if device.type == 'cuda':
                    torch.cuda.synchronize(device)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            if scaler is not None:
                scaler.append((scale, state.overflow))
            losses.append(loss)
            fired.append(fired_stage(flags))
            metrics = step_metrics(
                state, loss, None,
                scale if metrics_sink is not None else None)
            for k, v in metrics.items():
                if k != 'loss':
                    meters.setdefault(k, Metric(k)).update(v)
            _after_dispatch(state, metrics_sink, observers, metrics,
                            dispatch_ms, fired[-1], wait_ms, device,
                            epoch_cache)
            state.step += 1
            if checkpointer is not None:
                _after_step(checkpointer, state,
                            start_step_in_epoch + len(losses), metrics_sink,
                            observers)
    except (Preempted, Rollback) as p:
        p.partial = {'losses': [float(v) for v in losses], 'fired': fired,
                     'step_ms': step_ms if time_steps else None,
                     'scaler': _scaler_record(scaler)}
        raise
    losses = [float(v) for v in losses]
    metrics = {}
    if losses:
        mean = sum(losses) / len(losses)
        metrics = {'loss': mean, 'ppl': math.exp(min(mean, 20.0)),
                   **{k: m.avg for k, m in meters.items()}}
        if metrics_sink is not None:
            record_epoch(metrics_sink, state.epoch, metrics, len(losses),
                         time.perf_counter() - t_epoch)
    _flush_shard(observers)
    return {'metrics': metrics, 'losses': losses, 'fired': fired,
            'step_ms': step_ms if time_steps else None,
            'scaler': _scaler_record(scaler), 'stopped': stopped}


class TensorBoardWriter:
    """Epoch scalars to TensorBoard under ``log_dir`` (the JAX engine's
    writer, after the reference's ``SummaryWriter``), where the
    ``tensorboard`` package is installed; a no-op where it is not, as the
    JAX writer is without tensorflow.

    It writes the event file ``SummaryWriter`` writes (``brain.Event:2``
    records of ``simple_value`` scalars, framed by tensorboard's
    ``RecordWriter``) from tensorboard's own protos, without importing
    ``torch.utils.tensorboard``: that module resolves TensorFlow at import
    wherever it is installed (seconds per process), and its TF-free mode
    is a process-wide switch that breaks TensorFlow's own summaries.
    """

    def __init__(self, log_dir: str):
        try:
            from tensorboard.compat.proto import event_pb2, summary_pb2
            from tensorboard.summary.writer.record_writer import \
                RecordWriter
        except ImportError:  # tensorboard not installed: write nothing
            self._writer = None
            return
        import socket
        os.makedirs(log_dir, exist_ok=True)
        self._event, self._summary = event_pb2.Event, summary_pb2.Summary
        self._file = open(os.path.join(
            log_dir, f'events.out.tfevents.{int(time.time())}.'
                     f'{socket.gethostname()}.{os.getpid()}.0'), 'wb')
        self._writer = RecordWriter(self._file)
        self._write(self._event(wall_time=time.time(),
                                file_version='brain.Event:2'))

    def _write(self, event) -> None:
        self._writer.write(event.SerializeToString())

    def scalar(self, tag: str, value, step: int) -> None:
        if self._writer is not None:
            self._write(self._event(
                wall_time=time.time(), step=int(step),
                summary=self._summary(value=[self._summary.Value(
                    tag=tag, simple_value=float(value))])))

    def epoch(self, epoch: int, train: dict, val: dict) -> None:
        """``train/<k>`` and ``val/<k>`` of one epoch's averages."""
        for prefix, metrics in (('train', train), ('val', val)):
            for k, v in (metrics or {}).items():
                self.scalar(f'{prefix}/{k}', v, epoch)
        if self._writer is not None:
            self._file.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._file.close()
            self._writer = None
