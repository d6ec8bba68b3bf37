"""Train an ImageNet ResNet or Vision Transformer with K-FAC + SGD
(PyTorch port of ``examples/train_imagenet_resnet.py``), on one device or
data parallel.

    python -m distributed_kfac_pytorch_tpu_torch.train_imagenet_resnet \
        --model resnet50 --inverse-method newton

``--model`` takes ``resnet18`` ... ``resnet152`` and, as the JAX CLI,
``vit`` (ViT-S/16) or ``vit_<size>`` (``cifar``, ``tiny``, ``small``,
``base``; ``models.vit``); the name is parsed as strictly as there, so a
misspelt ViT name and ``--remat`` with a ViT raise ``SystemExit``.

Flags keep the JAX CLI's names and defaults for what the port supports
(the recipe: lr 0.0125 decayed at epochs 25/35/40/45/50, wd 5e-5, label
smoothing 0.1, inverses every 100 steps and factors every 10). The data
is synthetic ImageNet (``datasets.get_imagenet``: 3 x ``--image-size``^2
images, 1000 classes), which the JAX CLI does not augment either. Under a
process group (``torchrun``, or one the caller started) K-FAC runs as
``parallel.DistributedKFAC`` and each rank trains on its slice of the
global batch, as in the CIFAR CLI (same distribution flags); alone, the
single-device ``KFAC`` runs directly. Port-only flags: ``--device``
(default ``cuda``; ``cpu`` must be asked for), ``--dist-backend``,
``--deterministic`` (deterministic cuDNN convolutions: reruns and resumed
runs equal the uninterrupted run bit for bit), ``--synthetic-size``
(images per split), ``--no-augment`` (accepted as in the CIFAR CLI;
synthetic ImageNet is never augmented), ``--max-steps`` (stop after that
many steps), ``--time-steps`` (synchronize each step and record its
wall time) and ``--launch-counts`` (the kernels' launch counts to a JSON
file).

Checkpoints and resume as in the CIFAR CLI (``--checkpoint-dir``, default
``./checkpoints/imagenet``; ``--checkpoint-freq``, default 5 epochs;
``--checkpoint-steps``, ``--checkpoint-secs``, ``--preemption-grace``,
``--resume-step``, ``--no-resume``; exit 75 after a preemption). ``--grad-accum
N`` runs each rank's batch slice as ``N`` micro-batches in turn,
``--precise-bn-batches N`` re-estimates the BatchNorm statistics over the first
``N`` batches of the epoch's training stream before each evaluation (the
training statistics restored after it) and ``--remat`` rematerializes every
residual block (``models.imagenet_resnet``), as in the JAX CLI. ``--fp16`` (the
reference's production ImageNet recipe) builds the model, ResNet or ViT, at
``torch.float16`` compute with fp32 parameters and trains under the dynamic
loss scale with the overflow skip (``engine``; the SGD baseline exits), and
``KFAC_CHAOS=nan-batch@K`` poisons the batch of step ``K``. Not ported yet:
the ImageNet directory reader (the JAX CLI's ``tf.data`` JPEG pipeline) and the
flags of ``engine.UNPORTED_FLAGS`` (autotune and heartbeats), which raise
by name. ``--kfac-metrics``, ``--metrics-interval``, ``--health-action``,
``--profile-dir``, ``--memory-interval``, ``--no-perf-anomalies``,
``--straggler-shards``, ``--straggler-sample-every``, ``--selfheal*`` and
``--log-dir`` (default ``./logs/imagenet``) as in the CIFAR CLI.
``--bf16-factors``, ``--bf16-inverses`` and
``--bf16-precond`` set the K-FAC reduced-precision knobs as the JAX
``OptimConfig`` does (tracked config 5 is ``--model resnet152 --bf16-factors
--inverse-method eigen``). ``--inv-pipeline-chunks``, ``--inv-staleness``,
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
from distributed_kfac_pytorch_tpu_torch.models import imagenet_resnet, vit
from distributed_kfac_pytorch_tpu_torch.observability import cli as obs_cli
from distributed_kfac_pytorch_tpu_torch.resilience import \
    cli as resilience_cli
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import \
    RELAUNCH_EXIT_CODE
from distributed_kfac_pytorch_tpu_torch.training import datasets, engine, \
    optimizers, utils


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description='ImageNet ResNet + K-FAC (torch port)')
    p.add_argument('--data-dir', default=None,
                   help='ImageFolder-style tree (not ported: raises); '
                        'synthetic data if absent')
    resilience_cli.add_checkpoint_args(p, 'imagenet', 5)
    p.add_argument('--model', default='resnet50',
                   help="resnet18/34/50/101/152, 'vit' (ViT-S/16) or "
                        "'vit_<cifar|tiny|small|base>'")
    p.add_argument('--image-size', type=int, default=224)
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--val-batch-size', type=int, default=256)
    p.add_argument('--epochs', type=int, default=55)
    p.add_argument('--base-lr', type=float, default=0.0125)
    p.add_argument('--lr-decay', type=int, nargs='+',
                   default=[25, 35, 40, 45, 50])
    p.add_argument('--momentum', type=float, default=0.9)
    p.add_argument('--wd', type=float, default=5e-5)
    p.add_argument('--label-smoothing', type=float, default=0.1)
    p.add_argument('--bn-momentum', type=float, default=None,
                   help='BatchNorm running-stat EWMA momentum (flax '
                        'convention; default 0.9 = torch momentum 0.1)')
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--kfac-update-freq', type=int, default=100,
                   help='inverse update interval (0 = plain SGD)')
    p.add_argument('--kfac-cov-update-freq', type=int, default=10)
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
    p.add_argument('--inverse-method', default='auto',
                   choices=['auto', 'eigen', 'cholesky', 'newton'],
                   help='auto = eigen up to factor dim 640, damped '
                        'Cholesky above; newton = every factor by the '
                        'Newton-Schulz kernel')
    p.add_argument('--eigh-method', default='auto',
                   choices=['auto', 'xla', 'jacobi', 'warm'],
                   help='auto/warm = warm-start polish; xla = '
                        'torch.linalg.eigh; jacobi = the Jacobi '
                        'eigh kernel')
    p.add_argument('--eigh-polish-iters', type=int, default=8)
    p.add_argument('--stat-decay', type=float, default=0.95)
    p.add_argument('--damping', type=float, default=0.001)
    p.add_argument('--damping-alpha', type=float, default=0.5)
    p.add_argument('--damping-decay', type=int, nargs='+', default=[])
    p.add_argument('--kl-clip', type=float, default=0.001)
    p.add_argument('--skip-layers', nargs='+', default=[])
    engine.add_distributed_args(p)
    engine.add_precision_args(p)
    engine.add_schedule_args(p)
    resilience_cli.add_resilience_args(p)
    engine.add_precise_bn_arg(p)
    p.add_argument('--remat', action='store_true',
                   help='block-level gradient checkpointing: each '
                        'residual block recomputed in the backward pass '
                        '(about 1/3 more forward work for activation '
                        'memory O(depth)); fits larger batches')
    engine.add_observability_args(p, 'imagenet')
    engine.add_unported_args(p)
    # Port-only flags.
    engine.add_port_args(p)
    p.add_argument('--synthetic-size', type=int, default=512)
    p.add_argument('--no-augment', action='store_true')
    return p


def train(args_or_config=None, device='cuda') -> dict:
    """Train and return a summary dict.

    ``args_or_config``: an ``argparse.Namespace``, a list of CLI strings,
    or a dict of option overrides (``{'model': 'resnet18', 'epochs':
    1}``; checkpointing only when it sets ``checkpoint_dir``). ``device``
    (default ``'cuda'``) overrides ``--device``; it raises without a CUDA
    device unless ``'cpu'`` is asked for.

    Returns what :func:`engine.fit` returns, as the CIFAR ``train``
    does.
    """
    args = engine.parse_args(build_parser(), args_or_config)
    vit_size(args)
    dev = resolve_device(device if device is not None else args.device)
    engine.check_unported(args)
    preemption = engine.install_preemption(args)
    try:
        return _train(args, dev, preemption)
    finally:
        engine.finish_run(args, preemption)


def vit_size(args: argparse.Namespace) -> str | None:
    """The ViT size ``--model`` names (``'vit'`` is ``'small'``), or None
    for a ResNet. Strict, as the JAX CLI: exactly ``vit`` or
    ``vit_<size>``, so ``vitbase`` or ``vit-base`` cannot fall through to
    a default; ``--remat`` is the ResNet knob."""
    head, _, size = args.model.partition('_')
    if head == 'vit':
        if args.remat:
            raise SystemExit('--remat is the ResNet block-level knob; '
                             'for ViT memory use chunked attention '
                             '(models/vit.py attn_block_size)')
        return size or 'small'
    if args.model.startswith('vit'):
        raise SystemExit(
            f'unknown model {args.model!r}: ViT configs are spelled '
            "'vit' or 'vit_<tiny|small|base>'")
    return None


def build_model(args: argparse.Namespace) -> torch.nn.Module:
    """The ``--model`` network at ``--image-size``, 1000 classes, its
    weights drawn from ``--seed``, computing in fp16 under ``--fp16``."""
    size = vit_size(args)
    dtype = engine.compute_dtype(args)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        if size is not None:
            return vit.get_model(1000, size, image_size=args.image_size,
                                 dtype=dtype)
        return imagenet_resnet.get_model(
            args.model, dtype=dtype,
            bn_momentum=(0.9 if args.bn_momentum is None
                         else args.bn_momentum),
            remat=args.remat)


def _train(args: argparse.Namespace, dev: torch.device,
           preemption) -> dict:
    set_fp32_precision()
    engine.set_determinism(args)
    workers = engine.start_world(dev, args.dist_backend)
    sink, writer = engine.start_observability(
        args, 'train_imagenet_resnet',
        {'model': args.model, 'batch_size': args.batch_size,
         'devices': workers})
    observers = None
    try:
        train_data, val_data = datasets.get_imagenet(
            args.data_dir, image_size=args.image_size,
            synthetic_size=args.synthetic_size)
        model = build_model(args).to(dev)
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
            kl_clip=args.kl_clip, inverse_method=args.inverse_method,
            eigh_method=args.eigh_method,
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
        # Precise-BN draws the first batches of the epoch's training stream.
        precise_bn = engine.precise_bn_batches(
            args, model, lambda epoch: datasets.epoch_batches(
                *train_data, args.batch_size, seed=args.seed, epoch=epoch))
        state = engine.make_train_state(
            model, optimizer, kfac,
            coallocate_layer_factors=args.coallocate_layer_factors,
            num_slices=args.num_slices, grad_accum=args.grad_accum,
            fp16=args.fp16)
        ckpt = engine.start_checkpointing(
            args, state, kfac_sched, name='imagenet', device=dev,
            preemption=preemption, sink=sink, verbose=not args.quiet)
        observers = engine.make_observers(args, state, sink, dev,
                                          cli='train_imagenet_resnet')
        return engine.fit(
            state, train_data, val_data, lr_schedule=lr_schedule,
            kfac_sched=kfac_sched, epochs=args.epochs,
            batch_size=args.batch_size, val_batch_size=args.val_batch_size,
            seed=args.seed, augment=False, device=dev,
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
