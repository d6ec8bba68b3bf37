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

Checkpoints (:func:`start_checkpointing`, the JAX CLIs' wiring shared by
the three CLIs): the epoch loops resume at a bundle's point, skipping the
epoch's trained batches, call the ``resilience.policy.StepCheckpointer``
after each step (global-step bundles, the preemption drain, the
``KFAC_CHAOS`` faults), poll for preemption between epochs and save the
epoch bundle every ``--checkpoint-freq`` epochs and after the last. The
CLI flags the port does not run are :data:`UNPORTED_FLAGS`.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
import warnings
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu_torch import launch
from distributed_kfac_pytorch_tpu_torch.models.transformer_lm import \
    whole_sequences
from distributed_kfac_pytorch_tpu_torch.resilience import \
    cli as resilience_cli
from distributed_kfac_pytorch_tpu_torch.resilience import faults
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import (
    RELAUNCH_EXIT_CODE,
    Preempted,
    PreemptionHandler,
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
            'deferred_reduce': kfac.deferred_factor_reduction}


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


def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
               hyper: dict, flags: dict,
               criterion: Callable = F.cross_entropy
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One forward/backward, K-FAC preconditioning and SGD update, with
    the loss ``criterion(logits, labels)`` (default cross entropy).
    Returns the (device) loss and accuracy of the batch, averaged over
    the world when ``state.distributed``."""
    loss_fn = lambda out: criterion(out, y)  # noqa: E731
    kfac = state.kfac
    if kfac is None:
        state.optimizer.zero_grad(set_to_none=True)
        out = state.model(x)
        loss = loss_fn(out)
        loss.backward()
        loss, out = loss.detach(), out.detach()
        grads = {n: p.grad for n, p in state.model.named_parameters()
                 if p.grad is not None}
    else:
        loss, out, grads, captures = kfac.capture.loss_and_grads(
            loss_fn, x, intercept=flags['factor_update'])
    acc = accuracy(out, y)
    if state.distributed:
        *means, loss, acc = world_mean([*grads.values(), loss, acc])
        grads = dict(zip(grads, means))
    if kfac is not None:
        grads, state.kfac_state = kfac.step(
            state.kfac_state, grads, captures,
            damping=hyper.get('damping'), lr=hyper['lr'],
            **kfac_step_flags(flags))
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
                start_step_in_epoch: int = 0) -> dict:
    """One training epoch; returns the averaged metrics and, per step,
    the losses, the fired stage and (``time_steps``: each step
    synchronized) the wall milliseconds, and whether ``max_steps`` stopped
    it before its last batch (``stopped``).

    ``hyper`` holds this epoch's ``lr`` and, with K-FAC, ``damping`` and
    the update frequencies (``KFACParamScheduler.params()``). Stops after
    ``max_steps`` global steps when given. ``criterion`` is the training
    loss (see :func:`train_step`). ``checkpointer`` (a
    ``resilience.policy.StepCheckpointer``) is called after each step with
    the steps finished in the epoch, ``start_step_in_epoch`` (the
    mid-epoch resume offset) included; it may raise ``Preempted``, which
    then carries the epoch's record so far as ``partial``.
    """
    device = torch.device(device)
    state.model.train()
    meters: dict[str, Metric] = {}
    losses, fired, step_ms = [], [], []
    schedule = (epoch_schedule(state.kfac, hyper['inv_update_freq'])
                if state.kfac is not None else {})
    stopped = False
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
            t0 = time.perf_counter()
            loss, acc = train_step(state, x, y, hyper, flags, criterion)
            if time_steps:
                if device.type == 'cuda':
                    torch.cuda.synchronize(device)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            fired.append(fired_stage(flags))
            meters.setdefault('loss', Metric('loss')).update(loss)
            meters.setdefault('acc', Metric('acc')).update(acc)
            state.step += 1
            if checkpointer is not None:
                checkpointer.after_step(state,
                                        start_step_in_epoch + len(losses))
    except Preempted as p:
        p.partial = {'losses': [float(v) for v in losses], 'fired': fired,
                     'step_ms': step_ms if time_steps else None}
        raise
    out = {k: m.avg for k, m in meters.items()}
    if verbose and out:
        shown = {k: round(v, 4) for k, v in out.items()}
        print(f'epoch {state.epoch}: train {shown}')
    return {'metrics': out, 'losses': [float(v) for v in losses],
            'fired': fired, 'step_ms': step_ms if time_steps else None,
            'stopped': stopped}


def fit(state: TrainState, train_data, val_data, *, lr_schedule,
        kfac_sched, epochs: int, batch_size: int, val_batch_size: int,
        seed: int, augment: bool, device, max_steps: int | None = None,
        time_steps: bool = False, verbose: bool = False,
        criterion: Callable = F.cross_entropy,
        ckpt: 'Checkpointing | None' = None) -> dict:
    """The CLIs' epoch loop: per epoch, set the LR, train on the
    reshuffled ``(x, y)`` arrays of ``train_data`` (augmented with
    ``augment``), evaluate on ``val_data`` and advance the K-FAC
    scheduler; stop after ``max_steps`` global steps when given.

    With ``ckpt`` (:func:`start_checkpointing`) the loop starts at its
    resume point (``start_epoch``, skipping ``start_offset`` batches of
    that epoch), checkpoints each step through its ``StepCheckpointer``,
    polls for preemption between epochs and saves the epoch bundle every
    ``freq`` epochs and after the last; a preemption ends the loop.

    Returns ``{'device', 'steps', 'losses', 'fired', 'step_ms', 'train',
    'val', 'seconds', 'state', 'preempted'}``: per-step losses and fired
    stages (:func:`fired_stage`) of the steps this call ran, per-step
    wall ms when ``time_steps``, the last epoch's train / val metrics,
    the final ``TrainState`` and, after a preemption, its ``global_step``
    and ``reason`` (else None).
    """
    device = torch.device(device)

    def epoch_fn(epoch: int, skip: int, hyper: dict) -> dict:
        batches = datasets.epoch_batches(*train_data, batch_size, seed=seed,
                                         epoch=epoch, augment=augment,
                                         skip_batches=skip)
        return train_epoch(state, batches, hyper, device=device,
                           verbose=verbose, time_steps=time_steps,
                           max_steps=max_steps, criterion=criterion,
                           checkpointer=ckpt and ckpt.step_ckpt,
                           start_step_in_epoch=skip)

    def eval_fn(epoch: int) -> dict:
        return evaluate(
            state.model, datasets.epoch_batches(*val_data, val_batch_size,
                                                shuffle=False),
            device=device, epoch=epoch, verbose=verbose)

    return _epoch_loop(state, epoch_fn, eval_fn, lr_schedule=lr_schedule,
                       kfac_sched=kfac_sched, epochs=epochs,
                       max_steps=max_steps, time_steps=time_steps,
                       verbose=verbose, device=device, ckpt=ckpt)


def _epoch_loop(state: TrainState, epoch_fn, eval_fn, *, lr_schedule,
                kfac_sched, epochs: int, max_steps: int | None,
                time_steps: bool, verbose: bool, device,
                ckpt: 'Checkpointing | None') -> dict:
    """The epoch loop :func:`fit` and :func:`fit_lm` share:
    ``epoch_fn(epoch, skip, hyper)`` trains one epoch (a
    :func:`train_epoch` result), ``eval_fn(epoch)`` evaluates."""
    losses, fired, step_ms = [], [], []
    train_m = val_m = {}
    preempted = None
    start_epoch, start_offset = ((ckpt.start_epoch, ckpt.start_offset)
                                 if ckpt else (0, 0))
    t_start = time.perf_counter()
    try:
        for epoch in range(start_epoch, epochs):
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
            res = epoch_fn(epoch, skip, hyper)
            train_m = res['metrics'] or train_m
            losses += res['losses']
            fired += res['fired']
            if time_steps:
                step_ms += res['step_ms']
            val_m = eval_fn(epoch)
            if kfac_sched:
                kfac_sched.step(epoch + 1)
            # An epoch resumed at its end yields no batch and is done.
            state.epoch = epoch + 1
            if ckpt and not res['stopped']:
                ckpt.after_epoch(state, epoch, epochs)
    except Preempted as p:
        losses += p.partial['losses']
        fired += p.partial['fired']
        if time_steps:
            step_ms += p.partial['step_ms']
        preempted = {'global_step': p.global_step, 'reason': p.reason}
        if verbose:
            print(f'preempted ({p.reason}) at global step '
                  f'{p.global_step}; checkpoint saved — exiting '
                  f'{RELAUNCH_EXIT_CODE} for relaunch', flush=True)
    seconds = time.perf_counter() - t_start
    if verbose and preempted is None:
        print(f'total: {seconds:.1f}s')
    return {'device': str(device), 'steps': state.step, 'losses': losses,
            'fired': fired, 'step_ms': step_ms if time_steps else None,
            'train': train_m, 'val': val_m, 'seconds': seconds,
            'state': state, 'preempted': preempted}


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
    # JAX CLI flags the port does not run yet: setting one raises.
    p.add_argument('--grad-accum', type=int, default=1,
                   help='not ported (raises unless 1)')
    p.add_argument('--num-slices', type=int, default=1,
                   help='not ported (raises unless 1)')
    p.add_argument('--fp16', action='store_true',
                   help='not ported (raises)')


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


def schedule_config(args: argparse.Namespace) -> dict:
    """The ``OptimConfig`` fields of :func:`add_schedule_args`' flags."""
    return {key: getattr(args, key) for key in
            ('inv_pipeline_chunks', 'deferred_factor_reduction',
             'inv_staleness', 'factor_batch_fraction')}


def precision_config(args: argparse.Namespace) -> dict:
    """The ``OptimConfig`` fields of :func:`add_precision_args`' flags."""
    return {key: getattr(args, key) for key in
            ('bf16_factors', 'bf16_inverses', 'bf16_precond')}


#: Flags of the JAX CLIs the port does not run yet, by destination, with
#: their argparse definitions (the JAX names and "off" defaults; a path
#: flag is off at None): the sinks, profiling and autotune, heartbeats and
#: self-healing, precise-BN, rematerialization, the hierarchical reduce
#: and the low-rank inverse.
_UNPORTED_ARGS = {
    'log_dir': {},
    'hierarchical_reduce': {'action': 'store_true'},
    'inv_lowrank_rank': {'type': int, 'default': 0},
    'inv_lowrank_dim_threshold': {'type': int, 'default': 2048},
    'kfac_metrics': {'nargs': '?', 'const': 'auto'},
    'metrics_interval': {'type': int, 'default': 10},
    'health_action': {'choices': ['warn', 'skip', 'raise']},
    'profile_dir': {},
    'memory_interval': {'type': int, 'default': 100},
    'no_perf_anomalies': {'action': 'store_true'},
    'straggler_shards': {'action': 'store_true'},
    'straggler_sample_every': {'type': int, 'default': 1},
    'tuned_config': {},
    'cadence_backoff': {'action': 'store_true'},
    'backoff_skew_ms': {'type': float, 'default': 5.0},
    'backoff_sustain_steps': {'type': int, 'default': 8},
    'backoff_recover_steps': {'type': int, 'default': 32},
    'backoff_max_stretch': {'type': int, 'default': 4},
    'heartbeat_dir': {},
    'heartbeat_every': {'type': int, 'default': 1},
    'selfheal': {'action': 'store_true'},
    'selfheal_window': {'type': int, 'default': 0},
    'selfheal_damping_factor': {'type': float, 'default': 10.0},
    'selfheal_diverge_ratio': {'type': float, 'default': 10.0},
    'selfheal_no_quarantine': {'action': 'store_true'},
    'selfheal_max_rollbacks': {'type': int, 'default': 1},
    'precise_bn_batches': {'type': int, 'default': 0},
    'remat': {'action': 'store_true'},
}
#: The flags of :data:`_UNPORTED_ARGS` every CLI takes (the image CLIs add
#: ``precise_bn_batches``, the ImageNet CLI ``remat``).
COMMON_UNPORTED = tuple(k for k in _UNPORTED_ARGS
                        if k not in ('precise_bn_batches', 'remat'))


def _off(spec: dict):
    return spec.get('default', False if spec.get('action') else None)


#: Every flag the port does not run yet, with its "off" value: gradient
#: accumulation, multi-slice meshes and fp16, then :data:`_UNPORTED_ARGS`.
UNPORTED_FLAGS = (('grad_accum', 1), ('num_slices', 1), ('fp16', False),
                  *((k, _off(v)) for k, v in _UNPORTED_ARGS.items()))


def add_unported_args(p: argparse.ArgumentParser, *extra: str) -> None:
    """The :data:`COMMON_UNPORTED` flags plus ``extra`` ones of
    :data:`_UNPORTED_ARGS`, each raising by name when set
    (:func:`check_unported`)."""
    for dest in (*COMMON_UNPORTED, *extra):
        spec = _UNPORTED_ARGS[dest]
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
                        verbose: bool = False) -> Checkpointing | None:
    """The JAX CLIs' checkpoint wiring, shared by the three CLIs: None
    when ``--checkpoint-dir`` is None; else the epoch manager under
    ``--checkpoint-dir`` (``-sgd`` appended to the default directory
    without K-FAC), the step manager under its ``steps/``, the bundle
    builder and the resume (unless ``--no-resume``) into ``state``.

    A bundle holds the model's ``state_dict()`` (buffers included), the
    optimizer's (momentum), the K-FAC state with its inverses and bases
    (``include_inverses=True``), the K-FAC scheduler, ``extra_state()``
    (an LM's dropout generator state) and the resume scalars, with the
    digest field unhashed (the manager hashes each file it writes). On
    resume every part is loaded onto ``device`` (``load_extra`` takes the
    ``extra_vars``) and the scheduler steps to the resumed epoch.
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
        return checkpoint.bundle_state(
            st.model.state_dict(), st.optimizer.state_dict(), kfac_sd,
            extra_state() if extra_state else {},
            schedulers={'kfac': kfac_sched} if kfac_sched else None,
            integrity='template', step=st.step, epoch=st.epoch,
            step_in_epoch=int(step_in_epoch), data_seed=args.seed)

    start_epoch = start_offset = 0
    resumed = resilience_cli.resume(args, epoch_mgr, step_mgr,
                                    device=device, verbose=verbose)
    if resumed is not None:
        tree, start_epoch, start_offset, _ = resumed
        state.model.load_state_dict(tree['params'])
        state.optimizer.load_state_dict(tree['opt_state'])
        if state.kfac is not None:
            state.kfac_state = state.kfac.load_state_dict(tree['kfac'])
        if kfac_sched:
            kfac_sched.step(start_epoch)
        if load_extra is not None:
            load_extra(tree['extra_vars'])
        state.step = int(tree['scalars']['step'])
        state.epoch = start_epoch
    step_ckpt = resilience_cli.make_step_checkpointer(
        args, step_mgr, bundle_fn, preemption=preemption,
        start_step=state.step, verbose=verbose)
    return Checkpointing(epoch_mgr, step_ckpt, bundle_fn,
                         args.checkpoint_freq, start_epoch, start_offset)


def make_train_state(model, optimizer, kfac, *,
                     coallocate_layer_factors: bool = False,
                     seq_parallel: int = 1) -> TrainState:
    """The CLIs' ``TrainState``: with a process group up, data parallel
    over the world and ``kfac`` wrapped in ``DistributedKFAC`` (strategy
    from the ``KFAC``'s knobs; ``coallocate_layer_factors``: a layer's A
    and G on one rank; ``seq_parallel`` ranks per sequence group); else
    the single-device ``KFAC``."""
    distributed = dist.is_initialized()
    if kfac is not None and distributed:
        from distributed_kfac_pytorch_tpu_torch.parallel.distributed import (
            DistributedKFAC,
        )
        kfac = DistributedKFAC(kfac, distribute_layer_factors=(
            False if coallocate_layer_factors else None),
            seq_parallel=seq_parallel)
    return TrainState(
        model=model, optimizer=optimizer, kfac=kfac,
        kfac_state=kfac.init_state() if kfac is not None else None,
        distributed=distributed)


def parse_args(parser: argparse.ArgumentParser,
               args_or_config) -> argparse.Namespace:
    """A CLI's options from an ``argparse.Namespace`` (as is), a list of
    CLI strings, a dict of option overrides or None (the defaults).

    A dict or None starts with checkpointing off (``checkpoint_dir``
    None) unless it sets ``checkpoint_dir``: a programmatic run writes and
    resumes no bundles unless asked to. The command line keeps the JAX
    CLIs' default directory."""
    if args_or_config is None:
        args_or_config = {}
    if isinstance(args_or_config, argparse.Namespace):
        return args_or_config
    if isinstance(args_or_config, dict):
        args = parser.parse_args([])
        if hasattr(args, 'checkpoint_dir'):
            args.checkpoint_dir = None
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
    the SGD update. Returns the (device) loss."""
    model = state.model
    kwargs = {'dropout_generator': generator}
    if pos_offset:
        kwargs['pos_offset'] = pos_offset
    loss_fn = lambda out: lm_loss(out, targets)  # noqa: E731
    if state.kfac is None:
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model(ids, **kwargs))
        loss.backward()
        loss = loss.detach()
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
    else:
        loss, _, grads, captures = state.kfac.capture.loss_and_grads(
            loss_fn, ids, intercept=flags['factor_update'], **kwargs)
    if state.distributed:
        *means, loss = world_mean([*grads.values(), loss])
        grads = dict(zip(grads, means))
    if state.kfac is not None:
        grads, state.kfac_state = state.kfac.step(
            state.kfac_state, grads, captures,
            damping=hyper.get('damping'), lr=hyper['lr'],
            **kfac_step_flags(flags))
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
           ckpt: 'Checkpointing | None' = None) -> dict:
    """The LM CLI's epoch loop: per epoch, set the LR, train on the BPTT
    windows of ``train_ids`` (tracks offset per ``(seed, epoch)``; with
    ``fixed_batch`` every step takes epoch 0's first window instead;
    with ``state.distributed`` each rank its ``launch.process_local_tile``
    of the window under ``seq_parallel``), evaluate on ``val_ids`` and
    advance the K-FAC scheduler; stop after ``max_steps`` global steps
    when given. ``ckpt`` as in :func:`fit`.

    Returns what :func:`fit` returns; ``train`` and ``val`` hold the last
    epoch's ``loss`` and ``ppl``.
    """
    device = torch.device(device)
    first = next(datasets.bptt_batches(train_ids, batch_size, bptt,
                                       shuffle_offset=True, seed=seed,
                                       epoch=0))
    last = {}

    def epoch_fn(epoch: int, skip: int, hyper: dict) -> dict:
        windows = datasets.bptt_batches(train_ids, batch_size, bptt,
                                        shuffle_offset=True, seed=seed,
                                        epoch=epoch, skip_batches=skip)
        res = lm_train_epoch(
            state, windows, hyper, device=device, grad_clip=grad_clip,
            generator=generator, first=first if fixed_batch else None,
            seq_parallel=seq_parallel, time_steps=time_steps,
            max_steps=max_steps, checkpointer=ckpt and ckpt.step_ckpt,
            start_step_in_epoch=skip)
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
                       verbose=verbose, device=device, ckpt=ckpt)


def lm_train_epoch(state: TrainState, windows: Iterable, hyper: dict, *,
                   device, grad_clip: float = 0.0,
                   generator: torch.Generator | None = None, first=None,
                   seq_parallel: int = 1, time_steps: bool = False,
                   max_steps: int | None = None, checkpointer=None,
                   start_step_in_epoch: int = 0) -> dict:
    """One LM epoch over ``windows`` (each step on ``first`` instead when
    given): :func:`train_epoch`'s record, with ``metrics`` the epoch's
    mean ``loss`` and its ``ppl`` (empty without a step)."""
    schedule = (epoch_schedule(state.kfac, hyper['inv_update_freq'])
                if state.kfac is not None else {})
    state.model.train()
    losses, fired, step_ms = [], [], []
    stopped = False
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
            t0 = time.perf_counter()
            loss = lm_train_step(state, x, y, hyper, flags,
                                 grad_clip=grad_clip, generator=generator,
                                 pos_offset=offset)
            if time_steps:
                if device.type == 'cuda':
                    torch.cuda.synchronize(device)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            fired.append(fired_stage(flags))
            state.step += 1
            if checkpointer is not None:
                checkpointer.after_step(state,
                                        start_step_in_epoch + len(losses))
    except Preempted as p:
        p.partial = {'losses': [float(v) for v in losses], 'fired': fired,
                     'step_ms': step_ms if time_steps else None}
        raise
    losses = [float(v) for v in losses]
    metrics = {}
    if losses:
        mean = sum(losses) / len(losses)
        metrics = {'loss': mean, 'ppl': math.exp(min(mean, 20.0))}
    return {'metrics': metrics, 'losses': losses, 'fired': fired,
            'step_ms': step_ms if time_steps else None, 'stopped': stopped}
