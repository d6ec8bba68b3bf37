"""Chaos harness: run a training command under injected faults (PyTorch
port of ``distributed_kfac_pytorch_tpu/resilience/chaos.py``).

    python -m distributed_kfac_pytorch_tpu_torch.resilience.chaos \\
        'resize@3->2' --nproc 4 --relaunch 1 -- \\
        python -m distributed_kfac_pytorch_tpu_torch.train_cifar10_resnet \\
        --dist-backend gloo ...

Sets ``KFAC_CHAOS`` to the (validated) fault spec and runs the command as
a world of ``--nproc`` rank processes (``launch.spawn_world``: the
``torchrun`` environment for each; the default, 1, runs it alone, with no
process group). With ``--relaunch N`` it also plays supervisor: while the
world exits with ``RELAUNCH_EXIT_CODE`` (drained, bundle saved) it
relaunches, up to N times, with the fault spec cleared (faults are
one-shot; ``--keep-faults`` re-injects it). It handles only the
cooperative failure; crashes, hangs and dead ranks need
``resilience.supervisor``.

``resize@K->N`` makes the relaunch a change of world: it runs on N ranks,
which resume through the elastic reshard. ``slice-loss@K->S`` drains the
same way and relaunches on the S surviving slices: ``S * (n /
KFAC_NUM_SLICES)`` ranks with ``KFAC_NUM_SLICES=S`` exported (the CLIs'
``--num-slices`` default), failing closed when ``KFAC_NUM_SLICES`` is
missing or does not divide the world.

Exit status: the final world's exit code.
"""

from __future__ import annotations

import argparse
import os
import sys

from distributed_kfac_pytorch_tpu_torch import launch
from distributed_kfac_pytorch_tpu_torch.resilience import faults
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import (
    RELAUNCH_EXIT_CODE,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog='python -m distributed_kfac_pytorch_tpu_torch.resilience.chaos',
        description='Run a training command under injected faults '
                    '(sets KFAC_CHAOS), optionally relaunching while '
                    f'it exits {RELAUNCH_EXIT_CODE} (drained).')
    p.add_argument('spec',
                   help="fault spec 'kind@step[,kind@step...]'; kinds: "
                        'preempt, crash, nan-batch, crash-in-save, '
                        'corrupt-factor, corrupt-ckpt, diverge, '
                        'resize@K->N (relaunch on N ranks), '
                        'slice-loss@K->S (relaunch on the S surviving '
                        'slices with KFAC_NUM_SLICES=S), hang (wedge '
                        'without exit: needs the supervisor), slowrank '
                        "(persistent per-step delay on one rank) ('-' for "
                        'no faults: a pure relaunch loop)')
    p.add_argument('--nproc', type=int, default=1, metavar='N',
                   help='ranks of the first launch (1: one process, no '
                        'process group)')
    p.add_argument('--relaunch', type=int, default=0, metavar='N',
                   help='relaunch the command up to N times while it '
                        f'exits {RELAUNCH_EXIT_CODE}')
    p.add_argument('--keep-faults', action='store_true',
                   help='re-inject the fault spec on every relaunch '
                        '(default: faults fire on the first launch '
                        'only)')
    if argv is None:
        argv = sys.argv[1:]
    # Split at the first '--' here: argparse REMAINDER would swallow this
    # harness's own options.
    cmd: list[str] = []
    if '--' in argv:
        split = argv.index('--')
        argv, cmd = argv[:split], argv[split + 1:]
    args = p.parse_args(argv)
    if not cmd:
        p.error('no command given (append: -- python -m ...)')
    if args.nproc < 1:
        p.error('--nproc must be >= 1')
    spec = None if args.spec == '-' else args.spec
    plan = faults.parse_spec(spec)  # validate before launching anything

    env = dict(os.environ)
    if plan is not None:
        env[faults.ENV_VAR] = spec
    else:
        env.pop(faults.ENV_VAR, None)

    world = args.nproc
    launches = 0
    while True:
        rc = launch.spawn_world(cmd, world, env).wait()
        launches += 1
        if rc != RELAUNCH_EXIT_CODE or launches > args.relaunch:
            break
        note = ''
        if plan is not None and plan.resize_to is not None:
            world = plan.resize_to
            note = f' on {world} rank(s)'
        if plan is not None and plan.slice_loss_to is not None:
            prev = int(env.get('KFAC_NUM_SLICES', '0') or 0)
            if prev < 1 or world % prev:
                raise SystemExit(
                    'chaos: slice-loss relaunch needs KFAC_NUM_SLICES (a '
                    f'divisor of the {world} launched ranks) in the '
                    'environment to derive the per-slice rank count (got '
                    f'slices={prev})')
            if plan.slice_loss_to >= prev:
                raise SystemExit(
                    f'chaos: slice-loss@K->{plan.slice_loss_to} must '
                    f'name fewer than the {prev} launched slices')
            world = world // prev * plan.slice_loss_to
            env['KFAC_NUM_SLICES'] = str(plan.slice_loss_to)
            note = (f' on {plan.slice_loss_to} survivor slice(s) '
                    f'({world} ranks)')
        print(f'chaos: launch {launches} exited {rc} (drained) — '
              f'relaunching{note} ({launches}/{args.relaunch})',
              file=sys.stderr, flush=True)
        if not args.keep_faults:
            env.pop(faults.ENV_VAR, None)
    return rc


if __name__ == '__main__':
    sys.exit(main())
