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
be asked for, and gives a gloo group), ``--synthetic-size`` (train images
of the offline synthetic set), ``--no-augment``, ``--max-steps`` (stop
after that many steps) and ``--time-steps`` (synchronize each step and
record its wall time). Not ported yet: checkpointing and resume, metrics
sinks and profiling, gradient accumulation, multi-slice meshes and fp16
(``--grad-accum``, ``--num-slices``, ``--fp16`` raise), label smoothing,
precise-BN, and the K-FAC knobs listed in ``preconditioner.NOT_PORTED``.
``--bf16-factors``, ``--bf16-inverses`` and ``--bf16-precond`` set the
K-FAC reduced-precision knobs as the JAX ``OptimConfig`` does.
``--inv-pipeline-chunks``, ``--inv-staleness``,
``--deferred-factor-reduction`` and ``--factor-batch-fraction`` set the
firing-schedule knobs of the same names (``engine.add_schedule_args``).

:func:`train` is the programmatic entry point.
"""

from __future__ import annotations

import argparse
import sys

import torch

from distributed_kfac_pytorch_tpu_torch import resolve_device, \
    set_fp32_precision
from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
from distributed_kfac_pytorch_tpu_torch.training import datasets, engine, \
    optimizers


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description='CIFAR-10 ResNet + K-FAC (torch port)')
    p.add_argument('--data-dir', default=None,
                   help='CIFAR-10 python batches; synthetic data if absent')
    p.add_argument('--model', default='resnet32',
                   help='resnet20/32/44/56/110/1202')
    p.add_argument('--batch-size', type=int, default=128)
    p.add_argument('--val-batch-size', type=int, default=128)
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--base-lr', type=float, default=0.1)
    p.add_argument('--lr-decay', type=int, nargs='+', default=[35, 75, 90])
    p.add_argument('--momentum', type=float, default=0.9)
    p.add_argument('--wd', type=float, default=5e-4)
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
    p.add_argument('--kfac-update-freq-alpha', type=float, default=10)
    p.add_argument('--kfac-update-freq-decay', type=int, nargs='+',
                   default=[])
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
    # Port-only flags.
    p.add_argument('--device', default='cuda')
    p.add_argument('--synthetic-size', type=int, default=2048)
    p.add_argument('--no-augment', action='store_true')
    p.add_argument('--max-steps', type=int, default=None)
    p.add_argument('--time-steps', action='store_true')
    p.add_argument('--quiet', action='store_true')
    return p


def train(args_or_config=None, device='cuda') -> dict:
    """Train and return a summary dict.

    ``args_or_config``: an ``argparse.Namespace``, a list of CLI strings,
    or a dict of option overrides (``{'epochs': 2, 'batch_size': 8}``).
    ``device`` (default ``'cuda'``) overrides ``--device``; it raises
    without a CUDA device unless ``'cpu'`` is asked for.

    Returns what :func:`engine.fit` returns: per-step losses and fired
    stages, per-step wall ms when ``time_steps``, the last epoch's train /
    val metrics and the final ``TrainState``.
    """
    args = engine.parse_args(build_parser(), args_or_config)
    dev = resolve_device(device if device is not None else args.device)
    engine.check_unported(args)
    set_fp32_precision()
    workers = engine.start_world(dev)
    (train_x, train_y), (test_x, test_y) = datasets.get_cifar(
        args.data_dir, synthetic_size=args.synthetic_size)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = cifar_resnet.get_model(args.model,
                                       bn_momentum=args.bn_momentum)
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
        eigh_polish_iters=args.eigh_polish_iters,
        fused_factor_contraction=args.fused_factor_contraction,
        fused_precondition=args.fused_precondition,
        skip_layers=args.skip_layers,
        damping_alpha=args.damping_alpha,
        damping_schedule=args.damping_decay,
        kfac_update_freq_alpha=args.kfac_update_freq_alpha,
        kfac_update_freq_schedule=args.kfac_update_freq_decay,
        **engine.precision_config(args),
        **engine.schedule_config(args))
    optimizer, lr_schedule, kfac, kfac_sched = optimizers.get_optimizer(
        model, cfg, device=dev)
    state = engine.make_train_state(
        model, optimizer, kfac,
        coallocate_layer_factors=args.coallocate_layer_factors)
    return engine.fit(
        state, (train_x, train_y), (test_x, test_y),
        lr_schedule=lr_schedule, kfac_sched=kfac_sched, epochs=args.epochs,
        batch_size=args.batch_size, val_batch_size=args.val_batch_size,
        seed=args.seed, augment=not args.no_augment, device=dev,
        max_steps=args.max_steps, time_steps=args.time_steps,
        verbose=not args.quiet)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    train(args, device=args.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
