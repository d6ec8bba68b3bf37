"""Train a language model with K-FAC + SGD (PyTorch port of
``examples/train_language_model.py``): the LSTM (``--arch lstm``) or the
decoder-only Transformer (``--arch transformer``), on one device or data
parallel over a process group.

    python -m distributed_kfac_pytorch_tpu_torch.train_language_model \
        --inverse-method eigen --eigh-method jacobi
    torchrun --nproc-per-node 4 -m \
        distributed_kfac_pytorch_tpu_torch.train_language_model \
        --arch transformer --emsize 1024 --nlayers 18 --nheads 16 \
        --tied --bptt 1024 --batch-size 4 --kfac-approx reduce

Flags keep the JAX CLI's names and defaults for what the port supports:
the PTB "medium" widths (650-wide embedding and hidden, 2 layers; the
LSTM's 8-gate K-FAC cell, or for the Transformer ``--emsize`` wide blocks
with ``--nheads`` heads and a 4x MLP), BPTT 35, batch 20, dropout 0.5,
global-norm gradient clip 0.25, lr 1.0 decayed at epochs 20/30, momentum
0.9, damping 0.003, KL clip 0.001, stat decay 0.95, inverses every 10
steps and factors every step. K-FAC skips ``embed`` and ``decoder`` by
default under the LSTM and nothing under the Transformer, whose embedding
(a diagonal A over the vocabulary) and untied decoder are then
preconditioned too; ``--kfac-approx reduce`` takes the KFAC-reduce
statistics for every sequence-shared Linear and, with ``--tied``, the
tied attend site's statistics into the embedding's factors. The
Transformer's ``max_len`` is ``max(bptt, 16)``. Each BPTT window starts
from zero states, as the JAX CLI calls the model with ids only. The data
is whitespace-tokenized ``train.txt`` / ``valid.txt`` under
``--data-dir``, else the JAX package's synthetic Markov corpus.

Under a launcher's process group (``torchrun``'s environment) every rank
trains on its slice of each global batch of ``--batch-size`` sequences
and K-FAC runs as ``parallel.DistributedKFAC`` with the JAX CLI's
``--comm-method`` (default ``comm-opt``), ``--grad-worker-fraction``
(0.25) and ``--symmetry-aware-comm``; alone, the single-device ``KFAC``
runs (the JAX CLI wraps it in a one-device ``DistributedKFAC``, which
computes the same step). ``--warmup-epochs`` (default 1, the JAX LM
CLI's) goes to the LR schedule with one worker, as the JAX CLI passes
it: the LM's LR does not scale with the world, so the warm-up is flat.
Each rank seeds its dropout generator
with ``--seed`` plus its rank, so the ranks draw different masks (the
JAX CLI folds the device index into the step's key).

Long contexts (``--arch transformer`` only), as in the JAX CLI:
``--attn-block-size B`` folds attention over K/V blocks of ``B`` tokens
on each device (a ``--bptt`` above ``B`` must be a multiple of it);
``--seq-parallel N`` (K-FAC only) shards each BPTT window's positions
over sequence groups of ``N`` consecutive ranks of the process group,
attention running as a ring over each group and the KAISA grid over the
``world / N`` K-FAC ranks; ``--attn-block-size`` is then dropped. The
world must be a multiple of ``N``, and ``--bptt`` a multiple of ``N``
that gives each rank more than one position (``kfac_approx`` reads a
layer's shared positions from its rank's block). Validation runs whole
sequences without the ring, as the JAX CLI's evaluation twin does.

    torchrun --nproc-per-node 4 -m \
        distributed_kfac_pytorch_tpu_torch.train_language_model \
        --arch transformer --tied --bptt 1024 --batch-size 4 \
        --seq-parallel 2

Port-only flags: ``--device`` (default ``cuda``; ``cpu`` must be asked
for), ``--dist-backend``, ``--deterministic``, ``--synthetic-size`` and
``--synthetic-vocab`` (train tokens and vocabulary of the synthetic
corpus; the JAX defaults 200000 and 1000), ``--fixed-batch`` (every step
trains on the first window), ``--max-steps`` (stop after that many
steps), ``--time-steps`` (synchronize each step and record its wall time),
``--launch-counts`` (the kernels' launch counts to a JSON file) and
``--quiet``.

Checkpoints and resume as in the CIFAR CLI (``--checkpoint-dir``, default
``./checkpoints/lm``; ``--checkpoint-freq``, default 5 epochs;
``--checkpoint-steps``, ``--checkpoint-secs``, ``--preemption-grace``,
``--resume-step``, ``--no-resume``; exit 75 after a preemption); a bundle
also holds each rank's dropout generator state, so a resumed run draws
the masks the uninterrupted run draws. After a change of world a rank the
saving world did not have seeds its generator from ``--seed`` plus its
rank (the JAX CLI folds the data index into its key, which moves with the
world too).

``--bf16-factors``, ``--bf16-inverses`` and ``--bf16-precond`` set the
K-FAC reduced-precision knobs as the JAX ``OptimConfig`` does
(``engine.add_precision_args``).
``--inv-pipeline-chunks``, ``--inv-staleness``,
``--deferred-factor-reduction``, ``--factor-batch-fraction``,
``--hierarchical-reduce``, ``--inv-lowrank-rank`` and
``--inv-lowrank-dim-threshold`` set the K-FAC knobs of the same names
(``engine.add_schedule_args``); ``--num-slices`` splits a launched world
into contiguous slices (``parallel.DistributedKFAC(num_slices=)``).

``--fp16`` builds the LSTM or the Transformer at ``torch.float16`` compute
with fp32 parameters (fp32 attention scores) and trains under the dynamic
loss scale, unscaling before the global-norm clip, with the overflow skip
(``engine``; the SGD baseline exits). ``KFAC_CHAOS=nan-batch@K`` raises the
JAX CLI's ``ValueError`` at step ``K``: token windows hold no float to
poison.

``--kfac-metrics``, ``--metrics-interval``, ``--health-action``,
``--profile-dir``, ``--memory-interval``, ``--no-perf-anomalies``,
``--straggler-shards``, ``--straggler-sample-every``, ``--selfheal*`` and
``--log-dir`` (default ``./logs/lm``), ``--heartbeat-dir`` and
``--heartbeat-every``, ``--tuned-config``, ``--cadence-backoff`` and the
``--backoff-*`` envelope as in the CIFAR CLI.

:func:`train` is the programmatic entry point.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from distributed_kfac_pytorch_tpu_torch import resolve_device, \
    set_fp32_precision
from distributed_kfac_pytorch_tpu_torch.models import lstm_lm, \
    transformer_lm
from distributed_kfac_pytorch_tpu_torch.parallel import sequence
from distributed_kfac_pytorch_tpu_torch.autotune import cli as autotune_cli
from distributed_kfac_pytorch_tpu_torch.observability import cli as obs_cli
from distributed_kfac_pytorch_tpu_torch.resilience import \
    cli as resilience_cli
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import \
    RELAUNCH_EXIT_CODE
from distributed_kfac_pytorch_tpu_torch.training import datasets, engine, \
    optimizers


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description='Language model (LSTM or Transformer) + K-FAC, data '
                    'parallel under a process group (torch port)')
    p.add_argument('--data-dir', default=None,
                   help='dir with train.txt/valid.txt (synthetic if '
                        'absent)')
    resilience_cli.add_checkpoint_args(p, 'lm', 5)
    p.add_argument('--arch', default='lstm',
                   choices=['lstm', 'transformer'])
    p.add_argument('--emsize', type=int, default=650)
    p.add_argument('--nhid', type=int, default=650)
    p.add_argument('--nlayers', type=int, default=2)
    p.add_argument('--nheads', type=int, default=10,
                   help='attention heads (transformer)')
    p.add_argument('--dropout', type=float, default=0.5)
    p.add_argument('--tied', action='store_true')
    p.add_argument('--bptt', type=int, default=35)
    p.add_argument('--batch-size', type=int, default=20)
    p.add_argument('--epochs', type=int, default=40)
    p.add_argument('--base-lr', type=float, default=1.0)
    p.add_argument('--lr-decay', type=int, nargs='+', default=[20, 30])
    p.add_argument('--warmup-epochs', type=float, default=1)
    p.add_argument('--momentum', type=float, default=0.9)
    p.add_argument('--wd', type=float, default=0.0)
    p.add_argument('--grad-clip', type=float, default=0.25,
                   help='global-norm clip of every update (0 = off)')
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--seq-parallel', type=int, default=1,
                   help='ranks per sequence group: ring attention over '
                        'each BPTT window (transformer, K-FAC)')
    engine.add_num_slices_arg(p)
    p.add_argument('--attn-block-size', type=int, default=None,
                   help='chunked attention over K/V blocks of this many '
                        'tokens (transformer; dropped under '
                        '--seq-parallel)')
    p.add_argument('--kfac-update-freq', type=int, default=10,
                   help='inverse update interval; 0 disables K-FAC')
    p.add_argument('--kfac-cov-update-freq', type=int, default=1)
    p.add_argument('--fused-factor-contraction',
                   action=argparse.BooleanOptionalAction, default=True,
                   help='factor contraction + EMA kernel (default on)')
    p.add_argument('--fused-precondition',
                   action=argparse.BooleanOptionalAction, default=True,
                   help='bucketed preconditioning kernel (default on)')
    p.add_argument('--inverse-method', default='auto',
                   choices=['auto', 'eigen', 'cholesky', 'newton'],
                   help='auto = eigen up to factor dim 640, damped '
                        'Cholesky above (every LSTM gate factor: 650/651)')
    p.add_argument('--eigh-method', default='auto',
                   choices=['auto', 'xla', 'jacobi', 'warm'],
                   help='auto/warm = warm-start polish; xla = '
                        'torch.linalg.eigh; jacobi = the Jacobi eigh '
                        'kernel')
    p.add_argument('--eigh-polish-iters', type=int, default=8)
    p.add_argument('--stat-decay', type=float, default=0.95)
    p.add_argument('--damping', type=float, default=0.003)
    p.add_argument('--kl-clip', type=float, default=0.001)
    p.add_argument('--kfac-approx', default='expand',
                   choices=['expand', 'reduce'],
                   help='weight-sharing approximation: expand flattens '
                        'the sequence axis into covariance rows; reduce '
                        'averages activations / sums grads over it first '
                        '(and captures the tied attend site)')
    p.add_argument('--skip-layers', nargs='+', default=None,
                   help="default: ['embed', 'decoder'] for lstm (K-FAC on "
                        'the gates only), [] for transformer')
    p.add_argument('--comm-method', default='comm-opt',
                   choices=sorted(optimizers.COMM_METHODS))
    p.add_argument('--grad-worker-fraction', type=float, default=0.25)
    p.add_argument('--symmetry-aware-comm', action='store_true',
                   help='triangle-packed factor all_reduce (about half '
                        'the bytes)')
    engine.add_precision_args(p)
    engine.add_schedule_args(p)
    engine.add_fp16_arg(p)
    resilience_cli.add_resilience_args(p)
    engine.add_observability_args(p, 'lm')
    autotune_cli.add_autotune_args(p)
    # Port-only flags.
    engine.add_port_args(p)
    p.add_argument('--synthetic-size', type=int, default=200_000)
    p.add_argument('--synthetic-vocab', type=int, default=1000)
    p.add_argument('--fixed-batch', action='store_true')
    return p


def train(args_or_config=None, device='cuda') -> dict:
    """Train and return a summary dict.

    ``args_or_config``: an ``argparse.Namespace``, a list of CLI strings,
    or a dict of option overrides (``{'nhid': 32, 'max_steps': 2}``;
    checkpointing only when it sets ``checkpoint_dir``). ``device``
    (default ``'cuda'``) overrides ``--device``; it raises without a CUDA
    device unless ``'cpu'`` is asked for.

    Returns what :func:`engine.fit_lm` returns: per-step losses and fired
    stages ('inverse', 'factor' or None), per-step wall ms when
    ``time_steps``, the last epoch's train / val loss and perplexity,
    the final ``TrainState`` (under a process group its ``kfac`` is a
    ``DistributedKFAC``) and ``preempted``. The launch counts of the
    kernels are ``ops.kernels.LAUNCHES``.
    """
    args = engine.parse_args(build_parser(), args_or_config)
    engine.check_unported(args)
    check_long_context(args)
    dev = resolve_device(device if device is not None else args.device)
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
        args, 'train_language_model',
        {'arch': args.arch, 'batch_size': args.batch_size,
         'bptt': args.bptt, 'devices': workers})
    observers = None
    try:
        sp = args.seq_parallel
        # Before DistributedKFAC's groups: every rank creates every group in
        # the same order.
        seq_group = sequence.make_sequence_group(sp)
        train_ids, val_ids, vocab = datasets.get_lm_corpus(
            args.data_dir, synthetic_size=args.synthetic_size,
            vocab_size=args.synthetic_vocab)
        model = build_model(args, vocab, dev, seq_group)
        if args.skip_layers is not None:
            skip = args.skip_layers
        else:
            skip = ['embed', 'decoder'] if args.arch == 'lstm' else []
        # workers=1: the JAX LM CLI's LR does not scale with the world.
        cfg = optimizers.OptimConfig(
            base_lr=args.base_lr, momentum=args.momentum,
            weight_decay=args.wd, lr_decay=args.lr_decay,
            warmup_epochs=args.warmup_epochs, workers=1,
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
            kfac_approx=args.kfac_approx, skip_layers=skip,
            **engine.precision_config(args),
            **engine.observability_config(args),
            **engine.schedule_config(args))
        cfg = engine.apply_autotune(args, cfg, dev, sink)
        optimizer, lr_schedule, kfac, kfac_sched = optimizers.get_optimizer(
            model, cfg, device=dev)
        obs_cli.emit_layer_meta(sink, kfac)
        state = engine.make_train_state(model, optimizer, kfac,
                                        seq_parallel=sp,
                                        num_slices=args.num_slices,
                                        fp16=args.fp16)
        generator = torch.Generator(device=dev)
        generator.manual_seed(args.seed + (dist.get_rank() if state.distributed
                                           else 0))
        ckpt = engine.start_checkpointing(
            args, state, kfac_sched, name='lm', device=dev,
            preemption=preemption, sink=sink,
            extra_state=lambda: {'dropout_generator': generator.get_state()},
            load_extra=lambda extra: (
                generator.set_state(extra['dropout_generator'].cpu())
                if 'dropout_generator' in extra else None),
            verbose=not args.quiet)
        observers = engine.make_observers(args, state, sink, dev,
                                          cli='train_language_model')
        return engine.fit_lm(
            state, train_ids, val_ids, lr_schedule=lr_schedule,
            kfac_sched=kfac_sched, epochs=args.epochs,
            batch_size=args.batch_size, bptt=args.bptt, seed=args.seed,
            device=dev, grad_clip=args.grad_clip, generator=generator,
            fixed_batch=args.fixed_batch, max_steps=args.max_steps,
            time_steps=args.time_steps, verbose=not args.quiet,
            seq_parallel=sp, ckpt=ckpt, metrics_sink=sink,
            log_writer=writer, observers=observers)
    finally:
        engine.close_observability(sink, writer, observers)


def check_long_context(args: argparse.Namespace) -> None:
    """The JAX CLI's checks of ``--seq-parallel`` and
    ``--attn-block-size`` (``ValueError``; the world size is checked once
    the process group is up), and the port's: ``--bptt`` a multiple of
    ``--seq-parallel`` giving each rank more than one position."""
    sp, block = args.seq_parallel, args.attn_block_size
    if sp < 1:
        raise ValueError(f'--seq-parallel {sp} must be at least 1')
    if sp > 1 and args.arch != 'transformer':
        raise ValueError('--seq-parallel requires --arch transformer')
    if sp > 1 and not args.kfac_update_freq:
        raise ValueError('--seq-parallel requires the K-FAC step '
                         '(--kfac-update-freq > 0)')
    if sp > 1 and (args.bptt % sp or args.bptt // sp < 2):
        raise ValueError(f'--bptt {args.bptt} must be a multiple of '
                         f'--seq-parallel {sp} with more than one position '
                         'per rank')
    if block:
        if args.arch != 'transformer':
            raise ValueError('--attn-block-size requires '
                             '--arch transformer')
        if sp == 1 and args.bptt > block and args.bptt % block:
            raise ValueError(
                f'--bptt {args.bptt} must be divisible by '
                f'--attn-block-size {block} '
                '(e.g. --bptt 1024 --attn-block-size 256)')


def build_model(args: argparse.Namespace, vocab: int, device,
                seq_group=None) -> torch.nn.Module:
    """The ``--arch`` model from ``--seed``, on ``device``: its weights
    are drawn there (the LSTM's on the CPU, then moved), so a
    Transformer at full width never passes through host memory. A
    Transformer with a ``seq_group`` runs its attention as a ring over it
    (and drops ``--attn-block-size``). ``--fp16``: fp16 compute."""
    device = torch.device(device)
    dtype = engine.compute_dtype(args)
    if args.arch == 'lstm':
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(args.seed)
            model = lstm_lm.LSTMLanguageModel(
                vocab, embedding_dim=args.emsize, hidden_dim=args.nhid,
                num_layers=args.nlayers, dropout=args.dropout,
                tie_weights=args.tied, dtype=dtype)
        return model.to(device)
    cuda = [device] if device.type == 'cuda' else []
    with torch.random.fork_rng(devices=cuda), device:
        torch.manual_seed(args.seed)
        return transformer_lm.TransformerLM(
            vocab, d_model=args.emsize, num_layers=args.nlayers,
            num_heads=args.nheads, max_len=max(args.bptt, 16),
            dropout=args.dropout, tie_weights=args.tied,
            attn_block_size=(args.attn_block_size if seq_group is None
                             else None),
            seq_group=seq_group, dtype=dtype)


def main(argv=None) -> int:
    """The command line: 0 when training ends, ``RELAUNCH_EXIT_CODE``
    after a preemption drained into a saved bundle."""
    args = build_parser().parse_args(argv)
    res = train(args, device=args.device)
    return RELAUNCH_EXIT_CODE if res['preempted'] else 0


if __name__ == '__main__':
    sys.exit(main())
