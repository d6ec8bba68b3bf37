"""Fault injectors of the checkpoint path and the NaN batch (PyTorch port
of that part of ``distributed_kfac_pytorch_tpu/resilience/faults.py``).

A :class:`FaultPlan` names the global optimizer step at which each fault
fires; the plan rides in the ``KFAC_CHAOS`` environment variable so the
real CLIs run unmodified under injected failure. The grammar is the JAX
package's, comma-separated ``kind@step``, and every spec it accepts parses
alike. Every kind acts in the port:

    preempt@K         trigger the preemption handler after step K (a
                      graceful drain: forced blocking save, exit with
                      RELAUNCH_EXIT_CODE)
    crash@K           os._exit(137) after step K: an unclean kill (no
                      save, no atexit); resume falls back to the last
                      step or epoch bundle
    crash-in-save@K   die after step K's bundle files are written and
                      before the rename that commits them: the torn
                      write, which ``latest_epoch()`` never surfaces
    corrupt-ckpt@K    after a forced blocking save at step K, flip one
                      byte in the largest file of that bundle: the
                      verified resume walk must quarantine it
    nan-batch@K       poison the batch consumed at step K with a NaN
                      (:func:`poison_at`, which the CLIs wrap their batch
                      iterators in): under ``--fp16`` the dynamic loss
                      scale skips that step and backs off
    corrupt-factor@K  after step K, plant an infinity in one live
                      Kronecker factor (:func:`poison_factors`), outside
                      the K-FAC step: the self-healing quarantine rung's
                      proof fault
    diverge@K         after step K, scale every parameter by
                      ``DIVERGE_SCALE`` (:func:`poison_params`): a finite
                      loss spike, the damping-escalation rung's proof fault
    resize@K->N       after step K, drain like a preemption (forced
                      blocking save, exit RELAUNCH_EXIT_CODE, printing
                      ``resize -> N devices``); ``resilience.chaos``
                      relaunches the command on N ranks, which resume
                      through the elastic reshard
    slice-loss@K->S   after step K, drain the same way; the chaos harness
                      relaunches on the S surviving slices
                      (``S * per-slice ranks``, ``KFAC_NUM_SLICES=S``)
    hang@K            after step K (its lease already written), block
                      forever without exiting and without heartbeats
                      (:func:`hang`): the supervisor's lease expiry
                      (``--hang-timeout``) is what ends it
    slowrank@K        from step K on, one rank sleeps ``SLOWRANK_DELAY_S``
                      inside every step's timed window (:func:`slow_step`):
                      the persistent straggler the supervisor's classifier
                      reads from the rank shards

A world is rank processes that share the environment, so ``slowrank``
slows one rank: ``KFAC_SLOWRANK_RANK``, by default the world's last (the
JAX package's world is one process, which the fault slows whole). The
XLA device-count helpers of the JAX module (``xla_flags_with_device_count``,
``forced_device_count``) have no counterpart: a world's size is the number
of rank processes ``launch.spawn_world`` starts.

Faults are one-shot: a relaunch re-reads the environment, so relaunch
without ``KFAC_CHAOS`` unless the fault should fire again (the chaos
harness and the supervisor clear it); within a process the state faults
fire once, so an in-process rollback's replay of step K does not poison
again.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

ENV_VAR = 'KFAC_CHAOS'
_KINDS = ('preempt', 'crash', 'nan-batch', 'crash-in-save',
          'corrupt-factor', 'corrupt-ckpt', 'diverge', 'resize',
          'slice-loss', 'hang', 'slowrank')
#: One line of grammar per fault kind: error messages cite the whole menu.
_GRAMMAR = ('preempt@K, crash@K, nan-batch@K, crash-in-save@K, '
            'corrupt-factor@K, corrupt-ckpt@K, diverge@K, '
            'resize@K->N, slice-loss@K->S, hang@K, slowrank@K')
#: The kinds the port acts on, by their ``FaultPlan`` field.
PORTED = ('preempt_at', 'crash_at', 'crash_in_save_at', 'corrupt_ckpt_at',
          'nan_batch_at', 'corrupt_factor_at', 'diverge_at', 'resize_at',
          'slice_loss_at', 'hang_at', 'slowrank_at')
#: How hard ``diverge`` kicks the parameters (:func:`poison_params`).
DIVERGE_SCALE = 8.0
#: The ``slowrank`` fault's delay per step, in seconds (:func:`slow_step`).
SLOWRANK_DELAY_S = 0.25
#: The rank the ``slowrank`` fault slows under a process group (default:
#: the world's last rank).
SLOWRANK_RANK_ENV = 'KFAC_SLOWRANK_RANK'


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Global-step-indexed fault schedule (None = fault not armed)."""
    preempt_at: int | None = None
    crash_at: int | None = None
    nan_batch_at: int | None = None
    crash_in_save_at: int | None = None
    corrupt_factor_at: int | None = None
    corrupt_ckpt_at: int | None = None
    diverge_at: int | None = None
    resize_at: int | None = None
    resize_to: int | None = None  # new world size for resize_at
    slice_loss_at: int | None = None
    slice_loss_to: int | None = None  # survivor slice count
    hang_at: int | None = None
    slowrank_at: int | None = None

    def any(self) -> bool:
        return any(v is not None for v in dataclasses.astuple(self))


def parse_spec(spec: str | None) -> FaultPlan | None:
    """Parse a ``kind@step[,kind@step...]`` spec; None / '' -> None.

    Fails closed at parse time: an unknown kind, a malformed step or a
    repeated kind raises here, before any step runs. ``resize`` takes
    ``resize@<step>-><new_world_size>``, ``slice-loss``
    ``slice-loss@<step>-><survivor_slices>``; at most one of ``preempt``,
    ``resize`` and ``slice-loss`` per launch (all exit with the relaunch
    code).
    """
    if not spec:
        return None
    fields = {}
    for part in spec.split(','):
        part = part.strip()
        if not part:
            continue
        kind, sep, at = part.partition('@')
        if sep and kind == 'resize':
            step_s, arrow, to_s = at.partition('->')
            if not (arrow and step_s.lstrip('-').isdigit()
                    and to_s.isdigit() and int(to_s) > 0):
                raise ValueError(
                    f'bad {ENV_VAR} fault spec {part!r}: expected '
                    "'resize@<step>-><new_world_size>' (e.g. "
                    f"'resize@2->4'); valid fault kinds: {_GRAMMAR}")
            _set_once(fields, 'resize_at', int(step_s), part, spec)
            fields['resize_to'] = int(to_s)
            continue
        if sep and kind == 'slice-loss':
            step_s, arrow, to_s = at.partition('->')
            if not (arrow and step_s.lstrip('-').isdigit()
                    and to_s.isdigit() and int(to_s) > 0):
                raise ValueError(
                    f'bad {ENV_VAR} fault spec {part!r}: expected '
                    "'slice-loss@<step>-><survivor_slices>' (e.g. "
                    f"'slice-loss@2->1'); valid fault kinds: "
                    f'{_GRAMMAR}')
            _set_once(fields, 'slice_loss_at', int(step_s), part, spec)
            fields['slice_loss_to'] = int(to_s)
            continue
        if not sep or kind not in _KINDS:
            raise ValueError(
                f'bad {ENV_VAR} fault spec {part!r}: unknown fault '
                f'kind {kind!r} — valid fault kinds: {_GRAMMAR}')
        if not at.lstrip('-').isdigit():
            raise ValueError(
                f'bad {ENV_VAR} fault spec {part!r}: {at!r} is not an '
                f'integer step; valid fault kinds: {_GRAMMAR}')
        _set_once(fields, kind.replace('-', '_') + '_at', int(at),
                  part, spec)
    drains = [k for k in ('preempt_at', 'resize_at', 'slice_loss_at')
              if k in fields]
    if len(drains) > 1:
        raise ValueError(
            f'bad {ENV_VAR} spec {spec!r}: preempt/resize/slice-loss '
            'cannot be combined in one launch (all exit with the '
            'relaunch code, so the supervisor cannot attribute the '
            'drain); inject them on separate launches instead')
    return FaultPlan(**fields) if fields else None


def _set_once(fields: dict, key: str, value: int, part: str,
              spec: str) -> None:
    """A repeated kind is a spec bug (one step per kind): fail closed."""
    if key in fields:
        raise ValueError(
            f'bad {ENV_VAR} spec {spec!r}: fault kind in {part!r} '
            'appears more than once (each kind fires at ONE step; '
            'chain separate launches for repeated faults)')
    fields[key] = value


def plan_from_env() -> FaultPlan | None:
    """The process's fault plan per ``$KFAC_CHAOS`` (None = no chaos)."""
    return parse_spec(os.environ.get(ENV_VAR))


def check_ported(plan: FaultPlan | None) -> None:
    """Raise ``NotImplementedError`` naming any armed kind the port does
    not act on."""
    if plan is None:
        return
    armed = [f.name for f in dataclasses.fields(plan)
             if f.name.endswith('_at') and getattr(plan, f.name) is not None
             and f.name not in PORTED]
    if armed:
        kinds = ', '.join(a[:-3].replace('_', '-') for a in armed)
        raise NotImplementedError(
            f'{ENV_VAR} fault kind(s) {kinds} are not ported to torch yet '
            f'(the port injects {_GRAMMAR})')


def poison_batch(batch):
    """Copy of ``batch`` (a tuple of arrays) with one NaN planted in its
    first floating array (the model input): the smallest poison that
    reaches every gradient and factor capture. A batch without a floating
    array (an LM's token ids) raises ``ValueError``, as in the JAX
    package."""
    out = list(batch)
    for i, leaf in enumerate(out):
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.copy()
            arr.reshape(-1)[0] = np.nan
            out[i] = arr
            return tuple(out)
    raise ValueError('nan-batch fault: batch has no float leaf to poison')


def poison_at(batches, plan: FaultPlan | None, *, first_step: int = 0):
    """Wrap a batch iterator, poisoning the batch consumed at global step
    ``plan.nan_batch_at`` (``first_step``: the global step the first
    yielded batch is consumed at). Passthrough when the plan has no
    nan-batch fault."""
    if plan is None or plan.nan_batch_at is None:
        yield from batches
        return
    for i, batch in enumerate(batches):
        if first_step + i == plan.nan_batch_at:
            batch = poison_batch(batch)
        yield batch


def poison_factors(kfac_state: dict) -> dict:
    """The state with an infinity planted in one live Kronecker factor:
    the first element of the first factor (by key) of the first
    registered layer (by name), in a copy of that tensor. Applied outside
    the K-FAC step, so the non-finite guard never sees it: a silent
    in-memory corruption. Works on the ``KFAC`` and the
    ``DistributedKFAC`` state alike (``'factors'`` is a per-layer dict in
    both)."""
    factors = dict(kfac_state['factors'])
    name = sorted(factors)[0]
    entry = dict(factors[name])
    key = sorted(entry)[0]
    leaf = entry[key].clone()
    leaf.view(-1)[0] = float('inf')
    entry[key] = leaf
    factors[name] = entry
    return {**kfac_state, 'factors': factors}


def poison_params(params: dict, scale: float = DIVERGE_SCALE) -> dict:
    """Every floating-point tensor of ``params`` (name -> tensor) times
    ``scale``, in its dtype: a finite loss spike, the divergence signature
    the damping-escalation rung reads."""
    return {k: (p * scale).to(p.dtype) if isinstance(p, torch.Tensor)
            and p.is_floating_point() else p for k, p in params.items()}


def inject_state_faults(plan: FaultPlan | None, state, fired: set) -> None:
    """Apply the plan's live-state faults due after global step
    ``state.step`` (a ``TrainState``), each once per ``fired`` set (an
    in-process rollback replays the step without re-poisoning):
    ``corrupt-factor`` into ``state.kfac_state``, ``diverge`` into the
    model's parameters, in place."""
    if plan is None:
        return
    gstep = int(state.step)
    if plan.hang_at == gstep:
        hang()
    if plan.corrupt_factor_at == gstep and state.kfac_state is not None \
            and 'corrupt-factor' not in fired:
        fired.add('corrupt-factor')
        state.kfac_state = poison_factors(state.kfac_state)
    if plan.diverge_at == gstep and 'diverge' not in fired:
        fired.add('diverge')
        params = dict(state.model.named_parameters())
        with torch.no_grad():
            for name, p in poison_params(params).items():
                params[name].copy_(p)


class StateFaults:
    """The step hook of :func:`inject_state_faults` for a run without a
    step checkpointer (``resilience.policy.StepCheckpointer`` applies
    them itself); it does nothing when the plan has no state fault."""

    def __init__(self, plan: FaultPlan | None):
        self.plan = plan
        self._fired: set[str] = set()

    def after_step(self, state, step_in_epoch: int = 0) -> None:
        inject_state_faults(self.plan, state, self._fired)


def hard_crash(code: int = 137) -> None:
    """Die now: no save, no atexit (137 = 128 + SIGKILL)."""
    os._exit(code)


def hang() -> None:
    """Wedge now: no progress, no heartbeat, no exit. Sleeps in a loop
    forever; a first SIGTERM only sets the preemption flag, which is never
    polled again, so the supervisor's escalation to SIGKILL ends it."""
    import sys
    import time as _time

    print('chaos: hang fault — blocking without exit (no further '
          'heartbeats); kill me', file=sys.stderr, flush=True)
    while True:
        _time.sleep(60)


def slow_step(plan: FaultPlan | None, global_step: int) -> None:
    """The persistent-straggler delay: once ``global_step`` reaches
    ``plan.slowrank_at``, sleep :data:`SLOWRANK_DELAY_S` on this process;
    under a process group only on rank ``KFAC_SLOWRANK_RANK`` (default:
    the last). The engine calls it inside the step's timed window, so the
    slow rank's shard records the delay and the others wait in the next
    step's barrier probe."""
    if plan is None or plan.slowrank_at is None \
            or global_step < plan.slowrank_at:
        return
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        world = dist.get_world_size()
        slow = int(os.environ.get(SLOWRANK_RANK_ENV, world - 1))
        if dist.get_rank() != slow:
            return
    import time as _time

    _time.sleep(SLOWRANK_DELAY_S)


def corrupt_bundle_file(directory: str, step: int) -> str:
    """Flip one byte in the middle of the largest file of a committed
    bundle (``<directory>/<step>/``): the bit-rot fault. Returns the
    corrupted path."""
    root = os.path.join(directory, str(step))
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f'corrupt-ckpt fault: no committed bundle dir {root}')
    victim, size = None, -1
    for base, _dirs, files in os.walk(root):
        for f in sorted(files):
            p = os.path.join(base, f)
            s = os.path.getsize(p)
            if s > size:
                victim, size = p, s
    if victim is None or size == 0:
        raise FileNotFoundError(
            f'corrupt-ckpt fault: no non-empty file under {root}')
    with open(victim, 'r+b') as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    return victim


def torn_step_dir(directory: str, step: int) -> str:
    """What a writer killed before its commit leaves on disk: the
    uncommitted temporary directory ``<step>.partial`` (the commit is an
    atomic rename to ``<step>``), which ``CheckpointManager.latest_epoch()``
    never surfaces."""
    path = os.path.join(directory, f'{step}.partial')
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, '_partial_write'), 'w') as f:
        f.write('torn')
    return path
