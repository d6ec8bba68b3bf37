"""Train a CIFAR-10 ResNet with K-FAC + SGD (PyTorch port of
``examples/train_cifar10_resnet.py``), on one device or data parallel.

    python -m distributed_kfac_pytorch_tpu_torch.train_cifar10_resnet \
        --model resnet32 --epochs 100
    torchrun --nproc-per-node 4 -m \
        distributed_kfac_pytorch_tpu_torch.train_cifar10_resnet \
        --comm-method hybrid-opt --grad-worker-fraction 0.5

Flags keep the JAX CLI's names for what the port supports. Under a
process group (``torchrun``'s environment, or one the caller started)
``--batch-size`` is the global batch, each rank trains on its slice, and
K-FAC runs as ``parallel.DistributedKFAC`` (``--comm-method``,
``--grad-worker-fraction``, ``--coallocate-layer-factors``,
``--symmetry-aware-comm``; the LR warms up over ``--warmup-epochs`` to
world-size times ``--base-lr``); alone it runs the single-device
``KFAC``. Port-only flags: ``--device`` (default ``cuda``; ``cpu`` must
be asked for, and gives a gloo group), ``--dist-backend`` (``gloo`` runs
several ranks on one card), ``--deterministic`` (deterministic cuDNN
convolutions), ``--synthetic-size`` (train images of the offline
synthetic set), ``--no-augment``, ``--max-steps`` (stop after that many
steps), ``--time-steps`` (synchronize each step and record its wall
time) and ``--launch-counts`` (the kernels' launch counts to a JSON
file). ``--use-inv-kfac`` takes the damped Cholesky inverse for every
factor; ``--label-smoothing`` and ``--kfac-approx`` are the JAX CLI's.

Checkpoints, as in the JAX CLI: an epoch bundle every
``--checkpoint-freq`` epochs (and after the last) under
``--checkpoint-dir``, global-step bundles under its ``steps/``
(``--checkpoint-steps``, ``--checkpoint-secs``), and on SIGTERM / SIGINT
(or ``KFAC_PREEMPT_FILE``) a drain: the step finishes, a blocking bundle
is written and ``main`` returns ``RELAUNCH_EXIT_CODE`` (75), so a relaunch
loop restarts the run, which resumes from the newest bundle that verifies,
mid-epoch included (``--no-resume``, ``--resume-step``). ``train`` called
with a dict of options checkpoints only when the dict sets
``checkpoint_dir``.

``--grad-accum N`` runs each rank's batch slice as ``N`` micro-batches
in turn (``engine.accumulate_pass``); ``--precise-bn-batches N``
re-estimates the BatchNorm statistics over the first ``N`` augmented
training batches of epoch ``10_000 + epoch`` before each evaluation and
restores the training statistics after it (a model without BatchNorm,
such as ``resnet32gn``, exits). ``--fp16`` builds the model at
``torch.float16`` compute with fp32 parameters and trains under the
dynamic loss scale with the overflow skip (``engine``; the SGD baseline
exits), and ``KFAC_CHAOS=nan-batch@K`` poisons the batch of step ``K``.
``--kfac-metrics [PATH]`` writes the on-device K-FAC metrics to a JSONL
stream (default ``<log-dir>/kfac_metrics.jsonl``; every
``--metrics-interval`` steps, rank 0 only), ``--health-action
warn|skip|raise`` watches it (skip and raise also arm the non-finite
factor guard), and ``--log-dir`` (default ``./logs/cifar10``) takes
TensorBoard scalars where tensorboard is installed; read the stream with
``python -m distributed_kfac_pytorch_tpu_torch.observability.report
PATH`` (``observability.gate`` regresses it against a baseline).
``--profile-dir`` writes a ``torch.profiler`` trace of the first trained
epoch, ``--memory-interval`` memory records, ``--straggler-shards`` and
``--straggler-sample-every`` per-rank shards with the barrier probe's
waits, ``--no-perf-anomalies`` turns the monitor's perf checks off, and
``--selfheal*`` arm the self-healing ladder, whose rollback restores a
step bundle in the process (``engine``, ``resilience.selfheal``;
``KFAC_CHAOS=corrupt-factor@K`` and ``diverge@K`` are its proof faults).
Not ported yet (a set flag raises by name, ``engine.UNPORTED_FLAGS``):
autotune and heartbeats.
``--bf16-factors``, ``--bf16-inverses`` and ``--bf16-precond`` set the
K-FAC reduced-precision knobs as the JAX ``OptimConfig`` does.
``--inv-pipeline-chunks``, ``--inv-staleness``,
``--deferred-factor-reduction``, ``--factor-batch-fraction``,
``--hierarchical-reduce``, ``--inv-lowrank-rank`` and
``--inv-lowrank-dim-threshold`` set the K-FAC knobs of the same names
(``engine.add_schedule_args``); ``--num-slices`` splits a launched world
into contiguous slices (``parallel.DistributedKFAC(num_slices=)``).

:func:`train` is the programmatic entry point.
"""

from __future__ import annotations

import argparse
import functools
import sys

import torch

from distributed_kfac_pytorch_tpu_torch import resolve_device, \
    set_fp32_precision
from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
from distributed_kfac_pytorch_tpu_torch.observability import cli as obs_cli
from distributed_kfac_pytorch_tpu_torch.resilience import \
    cli as resilience_cli
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import \
    RELAUNCH_EXIT_CODE
from distributed_kfac_pytorch_tpu_torch.training import datasets, engine, \
    optimizers, utils


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description='CIFAR-10 ResNet + K-FAC (torch port)')
    p.add_argument('--data-dir', default=None,
                   help='CIFAR-10 python batches; synthetic data if absent')
    resilience_cli.add_checkpoint_args(p, 'cifar10', 10)
    p.add_argument('--model', default='resnet32',
                   help='resnet20/32/44/56/110/1202, with a gn suffix '
                        '(resnet32gn) for GroupNorm')
    p.add_argument('--batch-size', type=int, default=128)
    p.add_argument('--val-batch-size', type=int, default=128)
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--base-lr', type=float, default=0.1)
    p.add_argument('--lr-decay', type=int, nargs='+', default=[35, 75, 90])
    p.add_argument('--momentum', type=float, default=0.9)
    p.add_argument('--wd', type=float, default=5e-4)
    p.add_argument('--label-smoothing', type=float, default=0.0)
    p.add_argument('--bn-momentum', type=float, default=0.9,
                   help='flax convention: new = m*old + (1-m)*batch')
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--kfac-update-freq', type=int, default=10,
                   help='inverse update frequency (0 = plain SGD)')
    p.add_argument('--kfac-cov-update-freq', type=int, default=1)
    p.add_argument('--fused-factor-contraction',
                   action=argparse.BooleanOptionalAction, default=True,
                   help='factor contraction + EMA kernel (default on)')
    p.add_argument('--fused-precondition',
                   action=argparse.BooleanOptionalAction, default=True,
                   help='bucketed preconditioning kernel (default on)')
    p.add_argument('--kfac-approx', default='expand',
                   choices=['expand', 'reduce'],
                   help='weight-sharing Kronecker approximation: expand '
                        '(default) or reduce; a no-op for plain conv nets')
    p.add_argument('--kfac-update-freq-alpha', type=float, default=10)
    p.add_argument('--kfac-update-freq-decay', type=int, nargs='+',
                   default=[])
    p.add_argument('--use-inv-kfac', action='store_true',
                   help='Cholesky inverse method instead of eigen')
    p.add_argument('--eigh-method', default='auto',
                   choices=['auto', 'xla', 'jacobi', 'warm'],
                   help='auto/warm = warm-start polish; xla = '
                        'torch.linalg.eigh; jacobi = the Jacobi '
                        'eigh kernel')
    p.add_argument('--eigh-polish-iters', type=int, default=8)
    p.add_argument('--stat-decay', type=float, default=0.95)
    p.add_argument('--damping', type=float, default=0.003)
    p.add_argument('--damping-alpha', type=float, default=0.5)
    p.add_argument('--damping-decay', type=int, nargs='+', default=[])
    p.add_argument('--kl-clip', type=float, default=0.001)
    p.add_argument('--skip-layers', nargs='+', default=[])
    engine.add_distributed_args(p)
    engine.add_precision_args(p)
    engine.add_schedule_args(p)
    resilience_cli.add_resilience_args(p)
    engine.add_precise_bn_arg(p)
    engine.add_observability_args(p, 'cifar10')
    engine.add_unported_args(p)
    # Port-only flags.
    engine.add_port_args(p)
    p.add_argument('--synthetic-size', type=int, default=2048)
    p.add_argument('--no-augment', action='store_true')
    return p


def train(args_or_config=None, device='cuda') -> dict:
    """Train and return a summary dict.

    ``args_or_config``: an ``argparse.Namespace``, a list of CLI strings,
    or a dict of option overrides (``{'epochs': 2, 'batch_size': 8}``;
    checkpointing only when it sets ``checkpoint_dir``). ``device``
    (default ``'cuda'``) overrides ``--device``; it raises without a CUDA
    device unless ``'cpu'`` is asked for.

    Returns what :func:`engine.fit` returns: per-step losses and fired
    stages, per-step wall ms when ``time_steps``, the last epoch's train /
    val metrics, the final ``TrainState`` and, when a preemption ended
    the run, ``preempted``.
    """
    args = engine.parse_args(build_parser(), args_or_config)
    dev = resolve_device(device if device is not None else args.device)
    engine.check_unported(args)
    preemption = engine.install_preemption(args)
    try:
        return _train(args, dev, preemption)
    finally:
        engine.finish_run(args, preemption)


def _train(args: argparse.Namespace, dev: torch.device,
           preemption) -> dict:
    set_fp32_precision()
    engine.set_determinism(args)
    workers = engine.start_world(dev, args.dist_backend)
    sink, writer = engine.start_observability(
        args, 'train_cifar10_resnet',
        {'model': args.model, 'batch_size': args.batch_size,
         'devices': workers})
    observers = None
    try:
        (train_x, train_y), (test_x, test_y) = datasets.get_cifar(
            args.data_dir, synthetic_size=args.synthetic_size)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(args.seed)
            model = cifar_resnet.get_model(args.model,
                                           bn_momentum=args.bn_momentum,
                                           dtype=engine.compute_dtype(args))
        model = model.to(dev)
        cfg = optimizers.OptimConfig(
            base_lr=args.base_lr, momentum=args.momentum,
            weight_decay=args.wd, lr_decay=args.lr_decay,
            warmup_epochs=args.warmup_epochs, workers=workers,
            comm_method=args.comm_method,
            grad_worker_fraction=args.grad_worker_fraction,
            symmetry_aware_comm=args.symmetry_aware_comm,
            kfac_inv_update_freq=args.kfac_update_freq,
            kfac_cov_update_freq=args.kfac_cov_update_freq,
            damping=args.damping, factor_decay=args.stat_decay,
            kl_clip=args.kl_clip, eigh_method=args.eigh_method,
            inverse_method='cholesky' if args.use_inv_kfac else 'auto',
            eigh_polish_iters=args.eigh_polish_iters,
            fused_factor_contraction=args.fused_factor_contraction,
            fused_precondition=args.fused_precondition,
            kfac_approx=args.kfac_approx,
            skip_layers=args.skip_layers,
            damping_alpha=args.damping_alpha,
            damping_schedule=args.damping_decay,
            kfac_update_freq_alpha=args.kfac_update_freq_alpha,
            kfac_update_freq_schedule=args.kfac_update_freq_decay,
            **engine.precision_config(args),
            **engine.observability_config(args),
            **engine.schedule_config(args))
        optimizer, lr_schedule, kfac, kfac_sched = optimizers.get_optimizer(
            model, cfg, device=dev)
        obs_cli.emit_layer_meta(sink, kfac)
        # Precise-BN draws augmented training batches of epoch 10_000 + epoch
        # (the JAX CLI's stream, apart from the training epochs').
        precise_bn = engine.precise_bn_batches(
            args, model, lambda epoch: datasets.epoch_batches(
                train_x, train_y, args.batch_size, seed=args.seed,
                epoch=10_000 + epoch, augment=not args.no_augment))
        state = engine.make_train_state(
            model, optimizer, kfac,
            coallocate_layer_factors=args.coallocate_layer_factors,
            num_slices=args.num_slices, grad_accum=args.grad_accum,
            fp16=args.fp16)
        ckpt = engine.start_checkpointing(
            args, state, kfac_sched, name='cifar10', device=dev,
            preemption=preemption, sink=sink, verbose=not args.quiet)
        observers = engine.make_observers(args, state, sink, dev,
                                          cli='train_cifar10_resnet')
        return engine.fit(
            state, (train_x, train_y), (test_x, test_y),
            lr_schedule=lr_schedule, kfac_sched=kfac_sched, epochs=args.epochs,
            batch_size=args.batch_size, val_batch_size=args.val_batch_size,
            seed=args.seed, augment=not args.no_augment, device=dev,
            max_steps=args.max_steps, time_steps=args.time_steps,
            verbose=not args.quiet,
            criterion=functools.partial(utils.label_smooth_loss,
                                        smoothing=args.label_smoothing),
            ckpt=ckpt, precise_bn=precise_bn, metrics_sink=sink,
            log_writer=writer, observers=observers)
    finally:
        engine.close_observability(sink, writer, observers)


def main(argv=None) -> int:
    """The command line: 0 when training ends, ``RELAUNCH_EXIT_CODE``
    after a preemption drained into a saved bundle."""
    args = build_parser().parse_args(argv)
    res = train(args, device=args.device)
    return RELAUNCH_EXIT_CODE if res['preempted'] else 0


if __name__ == '__main__':
    sys.exit(main())
