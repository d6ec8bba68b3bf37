"""Entry points and package boundary of the torch port: the CPU must be
asked for, the package never imports JAX, unported knobs raise by name,
every flag of the JAX CLIs is accepted."""

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
from distributed_kfac_pytorch_tpu_torch.training import engine, optimizers
from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cli
from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet as inet
from distributed_kfac_pytorch_tpu_torch import train_language_model as lm


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


def test_cli_main_runs_on_cpu(capsys, tmp_path):
    # The command line checkpoints by default: into a test directory.
    assert cli.main(['--model', 'resnet20', '--batch-size', '8',
                     '--val-batch-size', '4', '--synthetic-size', '16',
                     '--epochs', '1', '--no-augment', '--device', 'cpu',
                     '--kfac-update-freq', '0',
                     '--checkpoint-dir', str(tmp_path / 'ck')]) == 0
    assert 'total:' in capsys.readouterr().out


INET_TINY = {'model': 'resnet50', 'image_size': 32, 'batch_size': 2,
             'val_batch_size': 2, 'synthetic_size': 2, 'epochs': 1,
             'inverse_method': 'cholesky', 'kfac_update_freq': 1,
             'kfac_cov_update_freq': 1, 'quiet': True}


def test_imagenet_train_on_cpu_one_step():
    # ResNet-50 at 32 px, batch 2: every layer registered, the inverse
    # firing at step 0 through the damped Cholesky buckets.
    res = inet.train({**INET_TINY, 'max_steps': 1, 'time_steps': True},
                     device='cpu')
    assert res['steps'] == 1 and res['device'] == 'cpu'
    assert len(res['losses']) == 1 and math.isfinite(res['losses'][0])
    assert res['fired'] == ['inverse']
    assert len(res['state'].kfac.specs) == 54


def test_imagenet_cli_rejects_vit_and_parses_flags():
    # Misspelt ViT names and --remat with a ViT are refused as in the JAX
    # CLI (the ViT models themselves are ported).
    for name in ('vitbase', 'vit-base', 'vits'):
        with pytest.raises(SystemExit, match='unknown model'):
            inet.train({**INET_TINY, 'model': name}, device='cpu')
    with pytest.raises(SystemExit, match='--remat'):
        inet.train({**INET_TINY, 'model': 'vit', 'remat': True},
                   device='cpu')
    args = inet.build_parser().parse_args(
        ['--inverse-method', 'newton', '--label-smoothing', '0.2'])
    assert (args.inverse_method, args.label_smoothing) == ('newton', 0.2)
    assert (args.base_lr, args.wd, args.kfac_update_freq,
            args.kfac_cov_update_freq, args.damping) == (0.0125, 5e-5, 100,
                                                         10, 0.001)


@pytest.mark.parametrize('name,size', [
    ('vit', 'small'), ('vit_small', 'small'), ('vit_tiny', 'tiny'),
    ('vit_base', 'base'), ('vit_cifar', 'cifar'), ('resnet50', None)])
def test_imagenet_cli_parses_vit_names_as_jax(name, size):
    args = inet.build_parser().parse_args(['--model', name])
    assert inet.vit_size(args) == size


def test_imagenet_cli_builds_vit_at_the_image_size():
    args = inet.build_parser().parse_args(
        ['--model', 'vit_cifar', '--image-size', '32'])
    model = inet.build_model(args)
    assert model.image_size == 32 and model.patch_size == 4
    assert tuple(model.pos_embed.shape) == (65, 192)
    with pytest.raises(ValueError, match='unknown size'):
        inet.build_model(inet.build_parser().parse_args(
            ['--model', 'vit_huge']))


def test_optim_config_passes_the_inverse_knobs_to_kfac():
    cfg = optimizers.OptimConfig(inverse_method='auto',
                                 auto_eigen_max_dim=40,
                                 auto_large_method='newton', newton_iters=7)
    _, _, kfac, _ = optimizers.get_optimizer(
        cifar_resnet.CifarResNet((1, 1, 1)), cfg, device='cpu')
    assert (kfac.inverse_method, kfac.auto_eigen_max_dim,
            kfac.auto_large_method, kfac.newton_iters) == ('auto', 40,
                                                          'newton', 7)
    assert [kfac.method_for_dim(d) for d in (40, 41)] == ['eigen', 'newton']


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
    with pytest.raises(RuntimeError, match='no CUDA device'):
        inet.train(INET_TINY)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        lm.train({'max_steps': 1})
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
    [*PACKAGE.rglob('*.py'), ROOT / 'chip_smoke.py',
     ROOT / 'scripts' / 'k4_ablation.py', ROOT / 'scripts' / 'k2_tiles.py',
     ROOT / 'scripts' / 'k2_ab.py',
     ROOT / 'scripts' / 'nccl_world1_repro.py',
     ROOT / 'scripts' / 'nccl_world1_profile.py']),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imports(path):
        top = name.split('.')[0]
        assert top not in FORBIDDEN, f'{path.name} imports {name}'


@pytest.mark.parametrize('module', [
    'resilience/__init__.py', 'resilience/dataiter.py',
    'resilience/preemption.py', 'resilience/integrity.py',
    'resilience/faults.py', 'resilience/policy.py', 'resilience/cli.py',
    'training/checkpoint.py'])
def test_no_jax_imports_reaches_the_checkpoint_modules(module):
    assert PACKAGE / module in set(PACKAGE.rglob('*.py'))
    test_no_jax_imports(PACKAGE / module)


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


@pytest.mark.parametrize('knob,value', [('collect_metrics', True)])
def test_unported_knobs_raise_by_name(knob, value):
    """Every knob of the JAX ``KFAC`` is ported, ``collect_metrics`` last
    (its runs are in ``tests/test_torch_metrics*.py``): it is a ``KFAC``
    attribute, and a knob the JAX ``KFAC`` does not have raises by name."""
    kfac = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
                **{knob: value})
    assert getattr(kfac, knob) == value
    with pytest.raises(TypeError, match='not_a_knob'):
        KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
             not_a_knob=value)


@pytest.mark.parametrize('knob,value', [
    ('inv_lowrank_rank', 16), ('inv_lowrank_dim_threshold', 1024),
    ('hierarchical_reduce', True)])
def test_lowrank_and_hierarchical_knobs_are_ported(knob, value):
    """The low-rank and hierarchical-reduce knobs are ``KFAC`` attributes
    (their runs are in ``tests/test_torch_lowrank*.py`` and
    ``tests/test_torch_multislice.py``), constructor parameters."""
    import inspect
    assert knob in inspect.signature(KFAC).parameters
    kfac = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
                **{knob: value})
    assert getattr(kfac, knob) == value


@pytest.mark.parametrize('module', [cli, inet, lm],
                         ids=['cifar', 'imagenet', 'lm'])
def test_fp16_and_nan_batch_are_ported(module):
    """``--fp16`` parses and is no unported flag, the guard is a ``KFAC``
    knob and ``nan-batch`` a ported fault kind (the flag's runs are in
    ``tests/test_torch_fp16_cli.py``)."""
    from distributed_kfac_pytorch_tpu_torch.resilience import faults
    assert not hasattr(engine, 'UNPORTED_FLAGS')
    assert module.build_parser().parse_args(['--fp16']).fp16
    assert KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
                nonfinite_guard=True).nonfinite_guard
    faults.check_ported(faults.parse_spec('nan-batch@3'))


@pytest.mark.parametrize('knob,value', [
    ('inv_pipeline_chunks', 2), ('deferred_factor_reduction', True),
    ('inv_staleness', 1), ('factor_batch_fraction', 0.5),
    ('inv_pipeline_costs', {64: 1.0})])
def test_schedule_knobs_are_kfac_attributes(knob, value):
    import inspect
    assert knob in inspect.signature(KFAC).parameters
    kfac = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
                inv_update_freq=10, **{knob: value})
    assert getattr(kfac, knob) == value


def test_distribution_knobs_are_kfac_attributes():
    import inspect

    from distributed_kfac_pytorch_tpu_torch.preconditioner import CommMethod
    knobs = {'comm_method': 'hybrid-opt', 'grad_worker_fraction': 0.5,
             'symmetry_aware_comm': True, 'assignment_strategy': 'memory'}
    assert set(knobs) <= set(inspect.signature(KFAC).parameters)
    kfac = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu', **knobs)
    assert kfac.comm_method is CommMethod.HYBRID_OPT
    assert (kfac.grad_worker_fraction, kfac.symmetry_aware_comm,
            kfac.assignment_strategy) == (0.5, True, 'memory')
    default = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu')
    assert default.comm_method is CommMethod.COMM_OPT
    with pytest.raises(ValueError, match='assignment_strategy'):
        KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
             assignment_strategy='speed')


# ImageNet CLI runs on the CPU leave stages 3-4 (factor dims up to 4608)
# out of K-FAC for time.
INET_SMALL = {'model': 'resnet18', 'image_size': 32, 'batch_size': 4,
             'val_batch_size': 2, 'synthetic_size': 8, 'epochs': 1,
             'inverse_method': 'cholesky', 'kfac_update_freq': 1,
             'kfac_cov_update_freq': 1, 'quiet': True,
             'skip_layers': ['layer3_block0', 'layer3_block1',
                             'layer4_block0', 'layer4_block1']}


@pytest.mark.parametrize('module,flags', [
    (cli, {'grad_accum': 2}), (cli, {'precise_bn_batches': 1}),
    (cli, {'model': 'resnet20gn', 'grad_accum': 4}),
    (cli, {'grad_accum': 2, 'kfac_update_freq': 0}),
    (inet, {'grad_accum': 2}), (inet, {'precise_bn_batches': 2}),
    (inet, {'remat': True}),
    (inet, {'remat': True, 'grad_accum': 2, 'precise_bn_batches': 1})],
    ids=['cifar-accum', 'cifar-precise-bn', 'cifar-gn-accum',
         'cifar-sgd-accum', 'imagenet-accum', 'imagenet-precise-bn',
         'imagenet-remat', 'imagenet-all-three'])
def test_wired_flags_run_a_step_on_cpu(module, flags):
    """The flags this slice wires run (no flag raises by name: the
    unported-flag table is gone)."""
    assert not hasattr(engine, 'UNPORTED_FLAGS')
    base = TINY if module is cli else INET_SMALL
    res = module.train({**base, 'max_steps': 2, **flags}, device='cpu')
    assert res['steps'] == 2
    assert all(math.isfinite(v) for v in res['losses'])
    assert math.isfinite(res['val']['loss'])


@pytest.mark.parametrize('module', [cli, inet], ids=['cifar', 'imagenet'])
def test_image_clis_parse_the_wired_flags(module):
    argv = ['--grad-accum', '4', '--precise-bn-batches', '3']
    if module is inet:
        argv.append('--remat')
    args = module.build_parser().parse_args(argv)
    assert (args.grad_accum, args.precise_bn_batches) == (4, 3)
    assert getattr(args, 'remat', True)
    assert '--remat' not in lm.build_parser()._option_string_actions
    assert '--grad-accum' not in lm.build_parser()._option_string_actions


JAX_CLI_SOURCES = {
    'cifar': ['examples/train_cifar10_resnet.py'],
    'imagenet': ['examples/train_imagenet_resnet.py'],
    'lm': ['examples/train_language_model.py']}
#: The flag helpers every JAX CLI calls (observability, resilience and
#: autotune's ``add_*_args``), read as text.
JAX_FLAG_HELPERS = ['distributed_kfac_pytorch_tpu/observability/cli.py',
                    'distributed_kfac_pytorch_tpu/resilience/cli.py',
                    'distributed_kfac_pytorch_tpu/autotune/cli.py']


def _jax_cli_flags(name: str) -> list[str]:
    import re
    flags = []
    for rel in JAX_CLI_SOURCES[name] + JAX_FLAG_HELPERS:
        flags += re.findall(r"add_argument\(\s*'(--[a-z0-9-]+)'",
                            (ROOT / rel).read_text())
    return sorted(set(flags))


@pytest.mark.parametrize('name,module', [('cifar', cli), ('imagenet', inet),
                                         ('lm', lm)],
                         ids=['cifar', 'imagenet', 'lm'])
def test_every_jax_cli_flag_is_wired_or_raises_by_name(name, module):
    flags = _jax_cli_flags(name)
    assert len(flags) > 60, flags
    options = module.build_parser()._option_string_actions
    missing = [f for f in flags if f not in options]
    assert not missing, f'{name}: JAX flags the port does not accept: ' \
                        f'{missing}'
    # Every flag is wired: none raises by name any more.
    assert not hasattr(engine, 'UNPORTED_FLAGS')
    assert {'--checkpoint-dir', '--checkpoint-freq', '--no-resume',
            '--checkpoint-steps', '--checkpoint-secs', '--preemption-grace',
            '--resume-step', '--fused-precondition',
            '--fused-factor-contraction', '--tuned-config',
            '--cadence-backoff', '--backoff-skew-ms',
            '--backoff-sustain-steps', '--backoff-recover-steps',
            '--backoff-max-stretch'} <= set(flags)


@pytest.mark.parametrize('name,module,freq', [('cifar10', cli, 10),
                                              ('imagenet', inet, 5),
                                              ('lm', lm, 5)])
def test_checkpoint_flags_take_the_jax_defaults(name, module, freq):
    args = module.build_parser().parse_args([])
    assert (args.checkpoint_dir, args.checkpoint_freq, args.no_resume,
            args.checkpoint_steps, args.checkpoint_secs,
            args.preemption_grace, args.resume_step) == (
        f'./checkpoints/{name}', freq, False, 0, 0.0, 30.0, None)
    # A programmatic run checkpoints only when asked to.
    assert engine.parse_args(module.build_parser(), {}).checkpoint_dir \
        is None
    assert engine.parse_args(module.build_parser(),
                             {'checkpoint_dir': 'x'}).checkpoint_dir == 'x'


@pytest.mark.parametrize('module', [cli, inet])
def test_clis_take_the_distribution_flags(module):
    args = module.build_parser().parse_args(
        ['--comm-method', 'hybrid-opt', '--grad-worker-fraction', '0.5',
         '--coallocate-layer-factors', '--symmetry-aware-comm',
         '--warmup-epochs', '2'])
    assert (args.comm_method, args.grad_worker_fraction,
            args.coallocate_layer_factors, args.symmetry_aware_comm,
            args.warmup_epochs) == ('hybrid-opt', 0.5, True, True, 2.0)


@pytest.mark.parametrize('kwargs', [{'inv_lowrank_rank': 8},
                                    {'inv_lowrank_rank': 8,
                                     'inv_lowrank_dim_threshold': 64}])
def test_unported_inverse_methods_raise(kwargs):
    """Every inverse method of the JAX ``KFAC`` is ported; a low-rank
    configuration that cannot truncate raises by name instead: rank 10 at
    threshold 8 engages the head's 10-wide G."""
    kfac = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu', **kwargs)
    assert kfac.method_for_dim(4096) == 'lowrank'
    with pytest.raises(ValueError, match='inv_lowrank_rank=10 must be <'):
        KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
             **{**kwargs, 'inv_lowrank_rank': 10,
                'inv_lowrank_dim_threshold': 8}).init_state()


@pytest.mark.parametrize('module', [cli, inet, lm])
@pytest.mark.parametrize('method', ['auto', 'xla', 'jacobi', 'warm'])
def test_clis_take_every_eigh_method(module, method):
    args = module.build_parser().parse_args(['--eigh-method', method])
    assert args.eigh_method == method
    kfac = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
                eigh_method=method)
    assert kfac.eigh_method == method
    with pytest.raises(SystemExit):
        module.build_parser().parse_args(['--eigh-method', 'qr'])


def test_auto_dispatch_above_640_raises_and_eigen_accepts():
    # 'auto' bakes a damped inverse above dim 640 (the A side here) and
    # keeps the eigen path below, so the layer is mixed; an unknown
    # large-dim method raises; 'eigen' decomposes every dim.
    model = nn.Sequential(nn.Linear(700, 3))
    state = KFAC(model, device='cpu').init_state()
    assert set(state['inverses']['0']) == {'A_inv', 'QG', 'dG', 'G_inv'}
    assert state['inverses']['0']['A_inv'].shape == (701, 701)
    with pytest.raises(ValueError, match='auto_large_method'):
        KFAC(model, device='cpu', auto_large_method='qr')
    with pytest.raises(ValueError, match='inverse_method'):
        KFAC(model, device='cpu', inverse_method='lu')
    state = KFAC(model, device='cpu', inverse_method='eigen').init_state()
    assert state['inverses']['0']['QA'].shape == (701, 701)


def test_unknown_knob_is_a_type_error():
    with pytest.raises(TypeError, match='no_such_knob'):
        KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
             no_such_knob=1)


def test_cadence_flags_classic_schedule():
    from distributed_kfac_pytorch_tpu.training import engine as jengine
    flags = [engine.cadence_flags(s, 1, 10) for s in range(21)]
    assert all(f['factor_update'] for f in flags)
    assert [s for s, f in enumerate(flags) if f['inv_update']] == [0, 10,
                                                                     20]
    chunked = [engine.cadence_flags(s, 1, 10, inv_pipeline_chunks=2)
               for s in range(21)]
    assert chunked == [jengine.cadence_flags(s, 1, 10, 2)
                       for s in range(21)]
    assert [(s, f['inv_chunk']) for s, f in enumerate(chunked)
            if 'inv_chunk' in f] == [(5, 1), (10, 0), (15, 1), (20, 0)]


def test_registration_and_declines():
    model = nn.Sequential(
        nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
        nn.Conv2d(8, 8, 3, padding=1, groups=2), nn.BatchNorm2d(8),
        nn.Conv2d(8, 4, 3, dilation=2), nn.Flatten(), nn.LazyLinear(5))
    model(torch.zeros(1, 3, 8, 8))
    cap = KFACCapture(model, skip_layers=['6'])
    assert list(cap.specs) == ['0', '2']
    assert cap.specs['2'].kind == 'conv2d_grouped'
    assert cap.specs['2'].feature_group_count == 2
    skipped = cap.skipped_modules
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
