"""Elastic resume of the torch port through the CIFAR CLI, as gloo worlds
of CPU processes (``launch.spawn_world``): the JAX package's acceptance pin
(``tests/test_elastic.py::TestElasticContract``) at the port's world sizes.

A 4-rank run drains at step 3 under ``KFAC_CHAOS=resize@3->2`` through
the chaos harness, which relaunches it on 2 ranks: the relaunch prints
``topology changed``, resumes at step 3 (no cold start) and trains to the
end; its stream holds ``topology_change`` then ``restore`` and the report
shows ``to_devices=2``. The step-3 bundle then resumes on 2 ranks and on
1 process (no group: the single-device ``KFAC``), each of which drains
again at once (the preemption sentinel), saving it on its own world, and
those bundles resume on 4 ranks: both runs end equal, file by file and bit
for bit, to the uninterrupted 4-rank run. ResNet-20 at batch 16, 2 epochs
of 4 steps, hybrid-opt 2 x 2 (2 x 1 on 2 ranks).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_kfac_pytorch_tpu_torch import launch
from distributed_kfac_pytorch_tpu_torch.observability import sink as obs_sink
from distributed_kfac_pytorch_tpu_torch.resilience import integrity
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import \
    RELAUNCH_EXIT_CODE

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ['--device', 'cpu', '--dist-backend', 'gloo', '--model', 'resnet20',
         '--batch-size', '16', '--val-batch-size', '16',
         '--synthetic-size', '64', '--epochs', '2', '--kfac-update-freq', '2',
         '--comm-method', 'hybrid-opt', '--grad-worker-fraction', '0.5',
         '--no-augment', '--checkpoint-steps', '100', '--checkpoint-freq',
         '1']
TIMEOUT = 300


def _cmd(directory: Path, *extra) -> list:
    return [sys.executable, '-m',
            'distributed_kfac_pytorch_tpu_torch.train_cifar10_resnet',
            *FLAGS, '--checkpoint-dir', str(directory), *extra]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != 'KFAC_CHAOS'}
    env.update(OMP_NUM_THREADS='1', PYTHONPATH=str(ROOT),
               PYTHONUNBUFFERED='1', **extra)
    return env


def _start(directory: Path, n: int, *extra, **env):
    return launch.spawn_world(_cmd(directory, *extra), n, _env(**env),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              cwd=str(ROOT))


def _finish(world, want: int) -> str:
    """Wait for ``world``; its rank 0 output (or every rank's, failing)."""
    try:
        rc = world.wait(TIMEOUT)
    finally:
        world.kill()
    outs = [p.stdout.read() for p in world.procs]
    assert rc == want, f'exit {rc}, expected {want}:\n' + '\n'.join(
        o[-3000:] for o in outs)
    return outs[0]


def _tree(directory: Path) -> dict:
    return {p.name: torch.load(p, map_location='cpu', weights_only=True)
            for p in sorted(directory.glob('*.pt'))}


def _equal(a, b, path='') -> list:
    """Paths where two bundle trees differ (bit for bit)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f'{path} keys']
        return [d for k in a if k != integrity.CHECKSUM_KEY
                for d in _equal(a[k], b[k], f'{path}/{k}')]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _equal(x, y, f'{path}[{i}]')]
    if isinstance(a, torch.Tensor):
        same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        return [] if same else [path]
    return [] if a == b else [path]


def _copy_step(src: Path, dst: Path, label: int) -> None:
    (dst / 'steps').mkdir(parents=True)
    shutil.copytree(src / 'steps' / str(label), dst / 'steps' / str(label))


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('elastic')
    sentinel = tmp / 'drain'
    sentinel.touch()
    ref = _start(tmp / 'ref', 4)
    chaos = subprocess.Popen(
        [sys.executable, '-m',
         'distributed_kfac_pytorch_tpu_torch.resilience.chaos',
         'resize@3->2', '--nproc', '4', '--relaunch', '1', '--',
         *_cmd(tmp / 'resize', '--kfac-metrics', str(tmp / 'resize.jsonl'),
               '--metrics-interval', '1')],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    out = {'ref': _finish(ref, 0)}
    out['resize'] = chaos.communicate(timeout=2 * TIMEOUT)[0]
    assert chaos.returncode == 0, out['resize'][-4000:]
    for name in ('two', 'one'):
        _copy_step(tmp / 'resize', tmp / name, 3)
    drains = [_start(tmp / 'two', 2, KFAC_PREEMPT_FILE=str(sentinel)),
              _start(tmp / 'one', 1, KFAC_PREEMPT_FILE=str(sentinel))]
    out['two'], out['one'] = [_finish(w, RELAUNCH_EXIT_CODE) for w in drains]
    back = [_start(tmp / 'two', 4), _start(tmp / 'one', 4)]
    out['two_back'], out['one_back'] = [_finish(w, 0) for w in back]
    return tmp, out


def test_resize_through_the_chaos_harness(worlds):
    tmp, out = worlds
    text = out['resize']
    assert 'resize -> 2 devices' in text
    assert 'relaunching on 2 rank(s)' in text
    assert 'elastic resume: topology changed — saved on 4 device(s) / 4 ' \
           'process(es), KAISA grid 2x2, resuming on 2 device(s) / 2 ' \
           'process(es), KAISA grid 2x1' in text
    assert 'resumed from step checkpoint 3' in text
    stream = obs_sink.read_jsonl(str(tmp / 'resize.jsonl'))
    steps = [r['step'] for r in stream if r['kind'] == 'step']
    assert steps == list(range(3, 8))       # no cold start
    events = [(r['event'], r.get('data', {})) for r in stream
              if r['kind'] == 'event'
              and r['event'] in ('topology_change', 'restore')]
    assert [e for e, _ in events] == ['topology_change', 'restore']
    change = events[0][1]
    assert change['resharded'] and change['from_devices'] == 4 \
        and change['to_devices'] == 2 and change['to_grid'] == '2x1'
    from distributed_kfac_pytorch_tpu_torch.observability import report
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert report.main([str(tmp / 'resize.jsonl')]) == 0
    assert 'topology_change' in buf.getvalue()
    assert 'to_devices=2' in buf.getvalue()


@pytest.mark.parametrize('via', ['two', 'one'])
def test_round_trip_continues_bit_for_bit(worlds, via):
    """4 -> 2 -> 4 and 4 -> 1 -> 4: the bundle re-saved on the other
    world resumes on 4 ranks and ends equal to the uninterrupted run."""
    tmp, out = worlds
    world = {'two': '2 device(s) / 2 process(es), KAISA grid 2x1',
             'one': '1 device(s) / 1 process(es), KAISA grid 1x1'}[via]
    assert f'resuming on {world}' in out[via]
    assert 'resumed from step checkpoint 3' in out[via]
    assert f'saved on {world}' in out[f'{via}_back']
    assert 'resumed from step checkpoint 3' in out[f'{via}_back']
    files = ['bundle.pt'] + [f'kfac_rank{r}.pt' for r in range(4)]
    got, want = _tree(tmp / via / '1'), _tree(tmp / 'ref' / '1')
    assert sorted(got) == sorted(want) == sorted(files)
    assert _equal(got, want) == []
