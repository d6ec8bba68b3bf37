"""The observability flags ported in this slice, run through each of the
three CLIs on the CPU at a tiny size (they no longer raise by name,
``engine.UNPORTED_FLAGS``), each checked for its effect:

  - ``--profile-dir``: a Chrome trace of the first epoch with the
    ``kfac/*`` scopes;
  - ``--memory-interval``: a ``kind='memory'`` record every N steps with
    the state footprint;
  - ``--no-perf-anomalies``: the health monitor built without the
    step-spike and memory-growth checks;
  - ``--straggler-shards``: the rank's shard next to the stream, a step
    record per step;
  - ``--straggler-sample-every``: the observers' sampling period.

The self-healing flags are ``tests/test_torch_selfheal_flags.py``.
"""

import json

import pytest
import torch

from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cifar
from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet as inet
from distributed_kfac_pytorch_tpu_torch import train_language_model as lm
from distributed_kfac_pytorch_tpu_torch.observability import cli as obs_cli
from distributed_kfac_pytorch_tpu_torch.observability import profiling, \
    sink, stragglers
from distributed_kfac_pytorch_tpu_torch.training import engine

CONFIGS = {
    'cifar': (cifar, {'model': 'resnet20', 'batch_size': 8,
                      'val_batch_size': 4, 'synthetic_size': 16,
                      'epochs': 1, 'no_augment': True,
                      'kfac_update_freq': 2, 'use_inv_kfac': True,
                      'max_steps': 2, 'quiet': True}),
    'imagenet': (inet, {'model': 'resnet18', 'image_size': 32,
                        'batch_size': 2, 'val_batch_size': 2,
                        'synthetic_size': 4, 'epochs': 1,
                        'inverse_method': 'cholesky', 'kfac_update_freq': 2,
                        'kfac_cov_update_freq': 1, 'max_steps': 2,
                        'quiet': True,
                        'skip_layers': ['layer2_block0', 'layer2_block1',
                                        'layer3_block0', 'layer3_block1',
                                        'layer4_block0', 'layer4_block1']}),
    'lm': (lm, {'emsize': 12, 'nhid': 12, 'synthetic_vocab': 40,
                'synthetic_size': 2000, 'bptt': 4, 'batch_size': 3,
                'max_steps': 2, 'epochs': 1, 'inverse_method': 'cholesky',
                'kfac_update_freq': 2, 'quiet': True}),
}

FLAGS = ('profile_dir', 'memory_interval', 'no_perf_anomalies',
         'straggler_shards', 'straggler_sample_every')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_flags_left_the_unported_table():
    assert not set(FLAGS) & {f for f, _ in engine.UNPORTED_FLAGS}


@pytest.mark.parametrize('flag', FLAGS)
@pytest.mark.parametrize('cli', list(CONFIGS))
def test_observability_flag_runs_with_its_effect(tmp_path, monkeypatch, cli,
                                                 flag):
    module, base = CONFIGS[cli]
    option = '--' + flag.replace('_', '-')
    assert option in module.build_parser()._option_string_actions
    path = tmp_path / 'm.jsonl'
    config = {**base, 'kfac_metrics': str(path), 'metrics_interval': 1}
    made = []
    real = engine.make_observers
    monkeypatch.setattr(engine, 'make_observers', lambda *a, **k: (
        made.append(real(*a, **k)) or made[-1]))
    monitors = []
    real_monitor = obs_cli.obs_health.HealthMonitor
    monkeypatch.setattr(obs_cli.obs_health, 'HealthMonitor', lambda **k: (
        monitors.append(k) or real_monitor(**k)))
    if flag == 'profile_dir':
        config['profile_dir'] = str(tmp_path / 'prof')
    elif flag == 'memory_interval':
        config['memory_interval'] = 1
    elif flag == 'no_perf_anomalies':
        config.update(no_perf_anomalies=True, health_action='warn')
    elif flag == 'straggler_shards':
        config['straggler_shards'] = True
    else:
        config.update(straggler_shards=True, straggler_sample_every=2)
    res = module.train(config, device='cpu')
    assert res['steps'] == 2
    records = sink.read_jsonl(str(path))
    if flag == 'profile_dir':
        files = profiling.trace_files(str(tmp_path / 'prof'))
        assert len(files) == 1
        names = {ev.get('name') for ev in
                 json.load(open(files[0]))['traceEvents']}
        assert {'kfac/factors', 'kfac/inverses', 'kfac/precond'} <= names
    elif flag == 'memory_interval':
        mem = [r for r in records if r['kind'] == 'memory']
        assert [r['step'] for r in mem] == [0, 1]
        assert mem[0]['state']['by_group']['factors'] > 0
        assert 'device' not in mem[0]       # no allocator stats off CUDA
    elif flag == 'no_perf_anomalies':
        assert monitors == [{'action': 'warn', 'stale_after_steps': 10,
                             'step_spike_zscore': None,
                             'memory_growth_windows': 0}]
    else:
        shard = [r for r in sink.read_jsonl(
            stragglers.rank_shard_path(str(path), 0)) if r['kind'] == 'step']
        assert [r['step'] for r in shard] == [0, 1]
        assert made[0].rank_sink is not None
        assert made[0].sample_every == (2 if flag ==
                                        'straggler_sample_every' else 1)
        # One process: no DistributedKFAC, so no barrier probe.
        assert made[0].barrier_probe is None


@pytest.mark.parametrize('cli', list(CONFIGS))
def test_observability_flag_rules(cli, tmp_path):
    module, base = CONFIGS[cli]
    args = module.build_parser().parse_args([])
    assert (args.profile_dir, args.memory_interval, args.no_perf_anomalies,
            args.straggler_shards, args.straggler_sample_every) == (
        None, 100, False, False, 1)
    with pytest.raises(SystemExit, match='--straggler-shards requires'):
        module.train({**base, 'straggler_shards': True}, device='cpu')
    with pytest.raises(SystemExit, match='requires --straggler-shards'):
        module.train({**base, 'kfac_metrics': str(tmp_path / 'm'),
                      'straggler_sample_every': 2}, device='cpu')
    with pytest.raises(SystemExit, match='must be >= 1'):
        module.train({**base, 'kfac_metrics': str(tmp_path / 'm'),
                      'straggler_shards': True,
                      'straggler_sample_every': 0}, device='cpu')
