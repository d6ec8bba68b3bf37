"""The CLIs' checkpoint and resilience wiring (PyTorch port of the
checkpoint part of ``distributed_kfac_pytorch_tpu/resilience/cli.py``):

    add_checkpoint_args(parser, 'cifar10', 10)  # --checkpoint-dir /
                                                # --checkpoint-freq /
                                                # --no-resume
    add_resilience_args(parser)     # --checkpoint-steps /
                                    # --checkpoint-secs /
                                    # --preemption-grace / --resume-step
    handler = install_preemption(args)          # SIGTERM/SIGINT + env
    step_mgr = make_step_manager(args)
    ckpt = make_step_checkpointer(args, step_mgr, bundle_fn,
                                  preemption=handler, start_step=0)
    resumed = resume(args, epoch_mgr, step_mgr, device=device,
                     elastic=ElasticResume(kfac))
    selfheal = make_selfheal(args, kfac=kfac, sink=sink, device=device)
    heartbeat = make_heartbeat(args, rank)

``resume`` unifies the two checkpoint trees: epoch bundles (every
``--checkpoint-freq`` epochs) and global-step bundles under
``<checkpoint-dir>/steps/``. Both record their resume point (``epoch`` to
(re)enter, offset by ``step_in_epoch`` batches; see
``resilience.dataiter``) and the newest point wins. With ``elastic`` a
bundle saved by another world (its ``topo_*`` scalars) is re-sharded for
this one (``elastic.reshard``) and a ``topology_change`` event is emitted.
``--selfheal*`` arm the self-healing ladder (:func:`make_selfheal`,
``resilience.selfheal``); ``--heartbeat-dir`` / ``--heartbeat-every`` (or
``KFAC_HEARTBEAT_DIR``) the per-rank liveness lease the supervisor watches
(:func:`make_heartbeat`, ``resilience.heartbeat``).
"""

from __future__ import annotations

import os
import time
import traceback
import warnings

import torch.distributed as dist

from distributed_kfac_pytorch_tpu_torch.resilience import \
    faults as faults_lib
from distributed_kfac_pytorch_tpu_torch.resilience import (
    integrity as integrity_lib,
    policy as policy_lib,
    preemption as preemption_lib,
)
from distributed_kfac_pytorch_tpu_torch.training import \
    checkpoint as ckpt_lib

STEP_SUBDIR = 'steps'


def add_checkpoint_args(p, name: str, freq: int) -> None:
    """The JAX CLIs' epoch-checkpoint flags: ``--checkpoint-dir``
    (default ``./checkpoints/<name>``), ``--checkpoint-freq`` (default
    ``freq`` epochs) and ``--no-resume``."""
    p.add_argument('--checkpoint-dir', default=f'./checkpoints/{name}')
    p.add_argument('--checkpoint-freq', type=int, default=freq)
    p.add_argument('--no-resume', action='store_true')


def add_resilience_args(p) -> None:
    """Resilience flags (the JAX CLIs' names, defaults and help)."""
    p.add_argument('--checkpoint-steps', type=int, default=0,
                   metavar='N',
                   help='save a global-step-indexed checkpoint every N '
                        'optimizer steps into <checkpoint-dir>/steps '
                        '(0 = epoch checkpoints only) — bounds '
                        'preemption loss for long epochs')
    p.add_argument('--checkpoint-secs', type=float, default=0.0,
                   metavar='S',
                   help='also step-checkpoint when S wall-clock seconds '
                        'have passed since the last one (0 = off; on a '
                        "pod, rank 0's clock decides and the verdict "
                        'is broadcast so the collective save stays in '
                        'lockstep)')
    p.add_argument('--preemption-grace', type=float, default=30.0,
                   metavar='S',
                   help='grace budget after SIGTERM/SIGINT (or a '
                        'KFAC_PREEMPT_FILE sentinel): finish the '
                        'in-flight step, force a blocking step '
                        'checkpoint, exit with code '
                        f'{preemption_lib.RELAUNCH_EXIT_CODE} so a '
                        'relaunch loop restarts the run (a second '
                        'signal kills immediately)')
    p.add_argument('--resume-step', type=int, default=None, metavar='G',
                   help='resume from this exact global-step checkpoint '
                        'in <checkpoint-dir>/steps (default: the '
                        'newest of step/epoch checkpoints)')
    p.add_argument('--heartbeat-dir', default=None, metavar='DIR',
                   help='publish a per-rank liveness lease (atomic '
                        'JSON file rank<r>.lease with global step, '
                        'wall time, incarnation) into DIR from the '
                        "train loop: the failure supervisor's hang / "
                        'dead-worker signal (default: the '
                        'KFAC_HEARTBEAT_DIR environment variable, unset = '
                        'no heartbeats; host file I/O only, bit for bit '
                        'the same run on and off)')
    p.add_argument('--heartbeat-every', type=int, default=1,
                   metavar='N',
                   help='publish the lease every N optimizer steps '
                        '(keyed to the global step, so a resumed run '
                        'keeps the cadence); budget --hang-timeout '
                        'above N steps + the eval/checkpoint gaps')
    p.add_argument('--selfheal', action='store_true',
                   help='arm the fault-response escalation ladder: '
                        'skip-window (the nonfinite guard, forced on) '
                        '-> damping escalation -> per-bucket layer '
                        'quarantine (the raw gradient while factors '
                        're-accumulate) -> in-process rollback to the '
                        'newest VERIFIED, finite step checkpoint. '
                        'Requires --kfac-metrics (the ladder reads the '
                        'on-device metrics); adds one host read per '
                        '--selfheal-window steps')
    p.add_argument('--selfheal-window', type=int, default=0,
                   metavar='N',
                   help='ladder observation window in optimizer steps '
                        '(0 = half the K-FAC inverse-update frequency: '
                        'two observations per cadence window, so a '
                        'factor corruption can be quarantined before the '
                        'next inverse firing decomposes it)')
    p.add_argument('--selfheal-damping-factor', type=float,
                   default=10.0, metavar='F',
                   help='damping multiplier applied per escalation on '
                        'repeated bad windows, divided back one notch '
                        'per clean window (rung 2)')
    p.add_argument('--selfheal-diverge-ratio', type=float,
                   default=10.0, metavar='R',
                   help='a window whose loss exceeds R x the running '
                        'boundary-loss average counts as a divergence '
                        'window (rung-2 trigger); lower R (e.g. 1.5) for '
                        'cross-entropy workloads, which saturate near '
                        'log(vocab)')
    p.add_argument('--selfheal-no-quarantine', action='store_true',
                   help='skip the per-bucket quarantine rung (the ladder '
                        'then goes skip -> damping -> rollback)')
    p.add_argument('--selfheal-max-rollbacks', type=int, default=1,
                   metavar='N',
                   help='in-process rollback budget; past it the ladder '
                        'is exhausted and the process ends for the '
                        'relaunch loop (the last rung)')


def make_heartbeat(args, rank: int):
    """The rank's :class:`resilience.heartbeat.HeartbeatEmitter` of a CLI
    run, or None when heartbeats are off. ``--heartbeat-dir`` wins over
    ``KFAC_HEARTBEAT_DIR`` (the supervisor's wiring: the supervised
    command line runs unmodified). Every rank writes its own lease."""
    directory = (getattr(args, 'heartbeat_dir', None)
                 or os.environ.get('KFAC_HEARTBEAT_DIR'))
    if not directory:
        return None
    from distributed_kfac_pytorch_tpu_torch.resilience import \
        heartbeat as heartbeat_lib
    return heartbeat_lib.HeartbeatEmitter(
        directory, rank,
        every=max(1, int(getattr(args, 'heartbeat_every', 1) or 1)))


def install_preemption(args) -> preemption_lib.PreemptionHandler:
    """Install the signal handler (plus the ``KFAC_PREEMPT_FILE``
    sentinel source when set). Call early, from the main thread: a notice
    that arrives before it kills the process."""
    handler = preemption_lib.PreemptionHandler(
        grace_secs=args.preemption_grace).install()
    sentinel = os.environ.get('KFAC_PREEMPT_FILE')
    if sentinel:
        handler.add_source(preemption_lib.file_source(sentinel))
    return handler


def make_step_manager(args) -> ckpt_lib.CheckpointManager:
    """The global-step manager under ``<checkpoint-dir>/steps`` (the
    epoch tree's integer scan ignores the subdirectory), keeping 2, or 10
    under ``--selfheal``: the rollback needs a bundle saved before the
    fault's onset, which the ladder detects up to ``rollback_after``
    windows late."""
    keep = 10 if getattr(args, 'selfheal', False) else 2
    return ckpt_lib.CheckpointManager(
        os.path.join(args.checkpoint_dir, STEP_SUBDIR), max_to_keep=keep)


def wants_selfheal_guard(args) -> bool:
    """True when the ladder is armed: rung 1 is the non-finite factor
    guard, without which a poisoned candidate enters the factors and
    ``nonfinite_skips`` never counts."""
    return bool(getattr(args, 'selfheal', False))


def make_selfheal(args, *, kfac, sink=None, device=None):
    """The :class:`resilience.selfheal.SelfHealController` of a CLI run
    under ``--selfheal`` (None otherwise). The ladder reads the on-device
    metrics and needs the K-FAC step: without ``--kfac-metrics`` or with
    ``--kfac-update-freq 0`` it raises the JAX CLIs' ``SystemExit``. The
    window defaults to half the inverse frequency; ``kfac`` (a ``KFAC``
    or ``DistributedKFAC``) gives the buckets the quarantine gates."""
    if not getattr(args, 'selfheal', False):
        return None
    from distributed_kfac_pytorch_tpu_torch.resilience import \
        selfheal as selfheal_lib
    if not getattr(args, 'kfac_metrics', None):
        raise SystemExit('--selfheal requires --kfac-metrics (the '
                         'ladder is driven by the on-device metrics '
                         'stream)')
    if kfac is None:
        raise SystemExit('--selfheal requires the K-FAC step '
                         '(--kfac-update-freq > 0)')
    window = int(getattr(args, 'selfheal_window', 0) or 0)
    if window <= 0:
        window = max(1, int(getattr(args, 'kfac_update_freq', 10)) // 2)
    cfg = selfheal_lib.SelfHealConfig(
        check_every=window,
        damping_factor=args.selfheal_damping_factor,
        diverge_ratio=args.selfheal_diverge_ratio,
        quarantine=not args.selfheal_no_quarantine,
        max_rollbacks=args.selfheal_max_rollbacks)
    bucket_layers = (None if args.selfheal_no_quarantine
                     else selfheal_lib.bucket_layer_map(kfac))
    return selfheal_lib.SelfHealController(
        cfg, bucket_layers=bucket_layers, sink=sink, device=device)


def make_step_checkpointer(args, step_mgr, bundle_fn, *,
                           preemption=None, start_step: int = 0,
                           verbose: bool = False, sink=None
                           ) -> policy_lib.StepCheckpointer:
    """The per-step hook: interval policy, preemption forcing and any
    ``KFAC_CHAOS`` fault plan (a kind the port does not inject raises
    ``NotImplementedError``). Always built, since preemption must be able
    to force a save. ``sink`` takes its save and preemption events."""
    plan = faults_lib.plan_from_env()
    faults_lib.check_ported(plan)
    pol = policy_lib.CheckpointPolicy(
        every_steps=args.checkpoint_steps,
        every_secs=args.checkpoint_secs, start_step=start_step)
    return policy_lib.StepCheckpointer(
        step_mgr, pol, bundle_fn, preemption=preemption, plan=plan,
        verbose=verbose, sink=sink)


def resume(args, epoch_mgr, step_mgr, *, device=None,
           verbose: bool = False, sink=None, elastic=None):
    """Restore the newest checkpoint (step or epoch tree), if any.

    Returns ``(restored_tree, start_epoch, start_offset, source)``, or
    None when there is nothing to resume (or ``--no-resume``); every
    tensor of the tree is on ``device``.

    Every candidate's files are verified as they are read; a bundle that
    fails to load or to verify is quarantined (a warning; a digest
    mismatch also moves it aside) and the walk goes on to the next older
    bundle of that tree.
    If bundles exist and none verifies, ``SystemExit``.

    Under a process group rank 0 walks, verifying every rank's file of
    each label, and broadcasts the label chosen (or the exit), so every
    rank loads the same bundle; the directory must be shared.

    ``sink`` (a metrics sink, written by rank 0) takes a ``restore`` event
    for the bundle resumed and a ``ckpt_quarantine`` event for each bundle
    the walk rejected, with the JAX package's fields.

    ``elastic`` (an ``elastic.ElasticResume`` of the live K-FAC): a bundle
    whose recorded topology (``topo_*`` scalars) is another world's, or
    another layout's, is read whole (every rank's file, verified) and each
    rank re-shards it for its own row (``elastic.reshard``); a
    ``topology_change`` event precedes the ``restore`` event. A bundle of
    another world without the record still raises. Without ``elastic``
    only same-world bundles restore.
    """
    if getattr(args, 'no_resume', False):
        return None
    group = dist.is_initialized() and dist.get_world_size() > 1
    t0 = time.perf_counter()
    if not group or dist.get_rank() == 0:
        kw = {'map_location': device, 'elastic': elastic is not None}
        if group:
            kw['all_ranks'] = True
        try:
            found = _choose(args, epoch_mgr, step_mgr, kw, sink)
        except SystemExit as e:
            found = None
            decision = ('exit', str(e))
        else:
            decision = (None if found is None
                        else (found[2], found[3]))
        if group:
            dist.broadcast_object_list([decision], src=0)
        if found is None:
            if decision is not None:
                raise SystemExit(decision[1])
            return None
        tree, (start_epoch, offset), source, label = found
    else:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        decision = box[0]
        if decision is None:
            return None
        if decision[0] == 'exit':
            raise SystemExit(decision[1])
        source, label = decision
        tree = (step_mgr if source == 'step' else epoch_mgr).restore(
            label, map_location=device, elastic=elastic is not None)
        sc = tree['scalars']
        start_epoch, offset = int(sc['epoch']), int(sc['step_in_epoch'])
    if elastic is not None:
        tree = _adopt_topology(tree, elastic,
                               step_mgr if source == 'step' else epoch_mgr,
                               label, device, sink=sink, verbose=verbose)
    ms = (time.perf_counter() - t0) * 1000.0
    # The bundle's data_seed is part of the data-stream position: adopt
    # it, or a relaunch without --seed would skip `offset` batches of
    # another permutation.
    saved_seed = tree['scalars'].get('data_seed')
    if saved_seed is not None and hasattr(args, 'seed'):
        saved_seed = int(saved_seed)
        if saved_seed != args.seed:
            if verbose:
                print(f'resume: adopting checkpoint data_seed '
                      f'{saved_seed} (relaunch passed --seed '
                      f'{args.seed}) to keep the batch replay exact')
            args.seed = saved_seed
    if sink is not None:
        sink.event_record('restore', source=source, label=int(label),
                          global_step=int(tree['scalars']['step']),
                          epoch=start_epoch, step_in_epoch=offset)
    if verbose:
        at = f', mid-epoch offset {offset}' if offset else ''
        print(f'resumed from {source} checkpoint {label} '
              f'(epoch {start_epoch}{at}, global step '
              f'{int(tree["scalars"]["step"])}) in {ms:.1f} ms',
              flush=True)
    return tree, start_epoch, offset, source


def _choose(args, epoch_mgr, step_mgr, kw, sink=None):
    """The walk of both trees: ``(tree, (epoch, offset), source, label)``
    of the newest resume point, or None."""
    candidates = []  # ((epoch, offset), tree, source, label)
    quarantined: list[str] = []
    found = _walk_restore(step_mgr, args, kind='step',
                          explicit=args.resume_step,
                          quarantined=quarantined, restore_kw=kw, sink=sink)
    if found is not None:
        label, tree = found
        sc = tree['scalars']
        candidates.append(((int(sc['epoch']), int(sc['step_in_epoch'])),
                           tree, 'step', label))
    if args.resume_step is None:
        # Epoch bundles record (e + 1, 0); walk only the labels that
        # could beat the step candidate.
        step_point = candidates[0][0] if candidates else None
        epoch_labels = [e for e in sorted(epoch_mgr.all_steps(),
                                          reverse=True)
                        if step_point is None or (e + 1, 0) > step_point]
        found = _walk_restore(epoch_mgr, args, kind='epoch',
                              labels=epoch_labels,
                              quarantined=quarantined, restore_kw=kw,
                              sink=sink)
        if found is not None:
            label, tree = found
            sc = tree['scalars']
            candidates.append(
                ((int(sc['epoch']), int(sc['step_in_epoch'])),
                 tree, 'epoch', label))
    if not candidates:
        if quarantined:
            # Bundles exist but none verifies: training from scratch
            # would silently discard the run's history.
            raise SystemExit(
                f'cannot resume under {args.checkpoint_dir}: every '
                f'checkpoint bundle failed restore/verification '
                f'({"; ".join(quarantined)}). Pass --no-resume to '
                'train from scratch or point --checkpoint-dir at a '
                'healthy tree.')
        return None
    point, tree, source, label = max(candidates, key=lambda c: c[0])
    return tree, point, source, label


def _walk_restore(mgr, args, *, kind: str,
                  explicit: int | None = None,
                  labels: list[int] | None = None,
                  quarantined: list[str] | None = None,
                  restore_kw: dict | None = None, sink=None):
    """Restore the newest verifiable bundle of one checkpoint tree.

    Walks ``labels`` (default: every label on disk, newest first); a
    bundle that fails to restore or to verify is quarantined and the walk
    goes on. ``explicit`` (``--resume-step``) pins the walk to that one
    label and turns its failures into ``SystemExit``. Returns ``(label,
    tree)`` or None.
    """
    restore_kw = restore_kw or {}
    if labels is None:
        labels = ([explicit] if explicit is not None
                  else sorted(mgr.all_steps(), reverse=True))
    if explicit is not None:
        qinfo = getattr(mgr, 'quarantine_info', lambda _l: None)(
            explicit)
        if qinfo is not None:
            qpath, qreason = qinfo
            raise SystemExit(
                f'cannot resume from {kind} checkpoint {explicit}: '
                f'that bundle was QUARANTINED by a previous verified '
                f'resume walk — moved to {qpath} because {qreason}. '
                'Quarantined bundles failed restore or integrity '
                'verification and are kept only for forensics; pick a '
                'different --resume-step or drop the flag to resume '
                'from the newest verifiable checkpoint.')
    for label in labels:
        what = f'{kind} checkpoint {label}'
        try:
            tree = mgr.restore(label, **restore_kw)
        except FileNotFoundError as e:
            if explicit is not None:
                raise SystemExit(f'cannot resume from {what}: {e}')
            _quarantine(sink, kind, label, f'restore failed: {e}',
                        quarantined)
            continue
        except integrity_lib.ChecksumMismatch as e:
            if explicit is not None:
                raise SystemExit(
                    f'cannot resume from {what}: {e}. The bundle is '
                    'corrupt on disk; drop --resume-step to walk back to '
                    'the newest verifiable checkpoint.')
            _quarantine(sink, kind, label, str(e), quarantined, mgr=mgr)
            continue
        except Exception as e:
            if explicit is not None:
                traceback.print_exc()  # keep the real cause diagnosable
                # Another world's bundle with a topology record reshards
                # (elastic resume): the world size is advice only for a
                # bundle without one.
                other = ('configuration or world size'
                         if isinstance(e, ckpt_lib.WorldMismatch)
                         else 'configuration')
                raise SystemExit(
                    f'cannot resume from {what} under '
                    f'{args.checkpoint_dir}: {e}\nThe checkpoint was '
                    f'likely written with a different model/K-FAC {other} '
                    '— pass --no-resume or a fresh --checkpoint-dir.')
            # No move: a load failure may hit every bundle alike (the
            # wrong world size, say), and moving the whole history would
            # make the next relaunch cold-start.
            _quarantine(sink, kind, label, f'restore failed: {e}',
                        quarantined)
            continue
        if getattr(mgr, 'verifies_on_restore', False):
            return label, tree
        ok, recorded, actual = integrity_lib.verify_tree(tree)
        if ok is False:
            reason = integrity_lib.describe_mismatch(recorded, actual)
            if explicit is not None:
                raise SystemExit(
                    f'cannot resume from {what}: {reason}. The bundle '
                    'is corrupt on disk; drop --resume-step to walk '
                    'back to the newest verifiable checkpoint.')
            _quarantine(sink, kind, label, reason, quarantined, mgr=mgr)
            continue
        if ok is None:
            warnings.warn(
                f'resume: {what} restored UNVERIFIED '
                f'({integrity_lib.describe_mismatch(recorded, actual)})',
                RuntimeWarning)
        return label, tree
    return None


def _quarantine(sink, kind: str, label, reason: str,
                quarantined: list[str] | None, mgr=None) -> None:
    """One rejected bundle: a warning and a ``ckpt_quarantine`` event in
    ``sink``, and the walk goes on. With ``mgr`` (a confirmed digest
    mismatch only) the bundle is also moved aside
    (``CheckpointManager.quarantine``)."""
    note = f'{kind} checkpoint {label}: {reason}'
    if quarantined is not None:
        quarantined.append(note)
    warnings.warn(f'resume: quarantining {note} — walking back to the '
                  'next older bundle', RuntimeWarning)
    if mgr is not None:
        try:
            mgr.quarantine(int(label), reason=str(reason))
        except OSError as e:  # best effort: never break the walk
            warnings.warn(f'resume: could not move quarantined '
                          f'{kind} checkpoint {label} aside: {e}',
                          RuntimeWarning)
    if sink is not None:
        sink.event_record('ckpt_quarantine', source=kind,
                          label=int(label), reason=str(reason)[:300])


def _adopt_topology(tree: dict, elastic, mgr, label, device, *, sink=None,
                    verbose: bool = False) -> dict:
    """The resumed tree for the live world: a bundle restored whole for
    another world (``tree['ranks']``), or of the same world size but
    another layout (read whole here), is re-sharded for this rank; a
    ``topology_change`` event and a line when the world changed."""
    from distributed_kfac_pytorch_tpu_torch.elastic import \
        topology as topo_lib
    saved = topo_lib.TopologySpec.from_scalars(tree.get('scalars', {}))
    live = elastic.topology
    if saved is not None and 'ranks' not in tree \
            and saved.needs_reshard(live):
        tree = mgr.restore_every_rank(int(label))
    if 'ranks' in tree:
        tree = elastic.reshard_tree(tree, saved, device)
    if saved is not None and saved != live:
        if sink is not None:
            sink.event_record(
                'topology_change',
                global_step=int(tree['scalars']['step']),
                resharded=bool(saved.needs_reshard(live)),
                from_processes=saved.processes, to_processes=live.processes,
                from_devices=saved.devices, to_devices=live.devices,
                from_grid=f'{saved.rows}x{saved.cols}',
                to_grid=f'{live.rows}x{live.cols}')
        if verbose:
            print(f'elastic resume: topology changed — saved on '
                  f'{saved.describe()}, resuming on {live.describe()}'
                  + ('' if saved.needs_reshard(live)
                     else ' (layout-compatible, no reshard)'), flush=True)
    return tree
