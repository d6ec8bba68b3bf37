"""Entry points and package boundary of the torch port: the CPU must be
asked for, the package never imports JAX, unported knobs raise by name."""

import ast
import math
import pathlib
import subprocess
import sys

import pytest
import torch
from torch import nn

from distributed_kfac_pytorch_tpu_torch import resolve_device
from distributed_kfac_pytorch_tpu_torch.capture import KFACCapture
from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine
from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cli


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / 'distributed_kfac_pytorch_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'distributed_kfac_pytorch_tpu')

TINY = {'model': 'resnet20', 'batch_size': 8, 'val_batch_size': 4,
        'synthetic_size': 16, 'epochs': 1, 'no_augment': True,
        'kfac_update_freq': 1, 'quiet': True}


def test_train_on_cpu_two_steps():
    res = cli.train({**TINY, 'max_steps': 2, 'time_steps': True},
                    device='cpu')
    assert res['steps'] == 2 and res['device'] == 'cpu'
    assert len(res['losses']) == 2
    assert all(math.isfinite(v) for v in res['losses'])
    assert res['fired'] == ['inverse', 'inverse']
    assert len(res['step_ms']) == 2
    assert math.isfinite(res['val']['loss'])


def test_cli_main_runs_on_cpu(capsys):
    assert cli.main(['--model', 'resnet20', '--batch-size', '8',
                     '--val-batch-size', '4', '--synthetic-size', '16',
                     '--epochs', '1', '--no-augment', '--device', 'cpu',
                     '--kfac-update-freq', '0']) == 0
    assert 'total:' in capsys.readouterr().out


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_default_device_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        KFAC(cifar_resnet.CifarResNet((1, 1, 1)))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.train(TINY)
    assert resolve_device('cpu') == torch.device('cpu')


def test_entry_points_turn_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu')
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize('path', sorted(
    [*PACKAGE.rglob('*.py'), ROOT / 'chip_smoke.py']),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imports(path):
        top = name.split('.')[0]
        assert top not in FORBIDDEN, f'{path.name} imports {name}'


def test_import_leaves_jax_unloaded():
    mods = sorted(str(p.relative_to(ROOT).with_suffix('')).replace('/', '.')
                  for p in PACKAGE.rglob('*.py')
                  if p.name != '__init__.py')
    code = ('import sys\n'
            + ''.join(f'import {m}\n' for m in mods)
            + f'bad = [m for m in sys.modules if m.split(".")[0] in '
              f'{FORBIDDEN!r}]\n'
            + 'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize('knob,value', [
    ('inv_pipeline_chunks', 2), ('deferred_factor_reduction', True),
    ('inv_staleness', 1), ('inv_lowrank_rank', 16),
    ('kfac_approx', 'reduce'), ('collect_metrics', True),
    ('inv_dtype', torch.bfloat16), ('auto_large_method', 'newton')])
def test_unported_knobs_raise_by_name(knob, value):
    with pytest.raises(NotImplementedError, match=knob):
        KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
             **{knob: value})


@pytest.mark.parametrize('kwargs', [{'inverse_method': 'newton'},
                                    {'inverse_method': 'cholesky'},
                                    {'use_eigen_decomp': False},
                                    {'eigh_method': 'jacobi'}])
def test_unported_inverse_methods_raise(kwargs):
    with pytest.raises(NotImplementedError, match='not ported'):
        KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu', **kwargs)


def test_auto_dispatch_above_640_raises_and_eigen_accepts():
    # 'auto' needs damped Cholesky inverses above dim 640 (not ported);
    # 'eigen' decomposes every dim.
    model = nn.Sequential(nn.Linear(700, 3))
    with pytest.raises(NotImplementedError, match='factor dim 701'):
        KFAC(model, device='cpu').init_state()
    state = KFAC(model, device='cpu', inverse_method='eigen').init_state()
    assert state['inverses']['0']['QA'].shape == (701, 701)


def test_unknown_knob_is_a_type_error():
    with pytest.raises(TypeError, match='no_such_knob'):
        KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
             no_such_knob=1)


def test_cadence_flags_classic_schedule():
    flags = [engine.cadence_flags(s, 1, 10) for s in range(21)]
    assert all(f['factor_update'] for f in flags)
    assert [s for s, f in enumerate(flags) if f['inv_update']] == [0, 10,
                                                                     20]
    with pytest.raises(NotImplementedError):
        engine.cadence_flags(0, 1, 10, inv_pipeline_chunks=2)


def test_registration_and_declines():
    model = nn.Sequential(
        nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
        nn.Conv2d(8, 8, 3, padding=1, groups=2), nn.BatchNorm2d(8),
        nn.Conv2d(8, 4, 3, dilation=2), nn.Flatten(), nn.LazyLinear(5))
    model(torch.zeros(1, 3, 8, 8))
    cap = KFACCapture(model, skip_layers=['6'])
    assert list(cap.specs) == ['0']
    skipped = cap.skipped_modules
    assert 'grouped conv' in skipped['2']
    assert 'dilated' in skipped['4']
    assert 'unsupported module type' in skipped['3']
    assert skipped['6'] == 'skip_layers match'


def test_resnet32_registers_31_convs_and_the_head():
    kfac = KFAC(cifar_resnet.get_model('resnet32'), device='cpu')
    kinds = [s.kind for s in kfac.specs.values()]
    assert kinds.count('conv2d') == 31 and kinds.count('linear') == 1
    state = kfac.init_state()
    shapes = {tuple(e['QA'].shape) + tuple(e['QG'].shape)
              for e in state['inverses'].values()}
    # The seven precondition buckets of the main path, as (a, g) dims.
    assert {(a, g) for a, _, g, _ in shapes} == {
        (27, 16), (144, 16), (144, 32), (288, 32), (288, 64), (576, 64),
        (65, 10)}
