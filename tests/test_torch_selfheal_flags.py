"""The self-healing flags ported in this slice, run through each of the
three CLIs on the CPU at a tiny size (no flag raises by name), each checked for its effect on the controller
the run builds (``resilience.cli.make_selfheal``): ``--selfheal`` arms
the ladder and the non-finite guard, ``--selfheal-window``,
``--selfheal-damping-factor``, ``--selfheal-diverge-ratio`` and
``--selfheal-max-rollbacks`` set its config, ``--selfheal-no-quarantine``
drops the quarantine rung (no gates in the step's hyper).
"""

import pytest
import torch

from distributed_kfac_pytorch_tpu_torch.resilience import selfheal
from distributed_kfac_pytorch_tpu_torch.training import engine

from test_torch_obs_flags import CONFIGS

FLAGS = {'selfheal': ({}, lambda c: c.config.check_every == 1),
         'selfheal_window': ({'selfheal_window': 3},
                             lambda c: c.config.check_every == 3),
         'selfheal_damping_factor': (
             {'selfheal_damping_factor': 4.0},
             lambda c: c.config.damping_factor == 4.0),
         'selfheal_diverge_ratio': (
             {'selfheal_diverge_ratio': 2.5},
             lambda c: c.config.diverge_ratio == 2.5),
         'selfheal_no_quarantine': (
             {'selfheal_no_quarantine': True},
             lambda c: c.bucket_layers is None
             and not c.config.quarantine),
         'selfheal_max_rollbacks': (
             {'selfheal_max_rollbacks': 2},
             lambda c: c.config.max_rollbacks == 2)}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_flags_left_the_unported_table():
    assert not hasattr(engine, 'UNPORTED_FLAGS')
    for module, _ in CONFIGS.values():
        options = module.build_parser()._option_string_actions
        assert {'--' + f.replace('_', '-') for f in FLAGS} <= set(options)


@pytest.mark.parametrize('flag', list(FLAGS))
@pytest.mark.parametrize('cli', list(CONFIGS))
def test_selfheal_flag_builds_the_controller(tmp_path, monkeypatch, cli,
                                             flag):
    module, base = CONFIGS[cli]
    option = '--' + flag.replace('_', '-')
    assert option in module.build_parser()._option_string_actions
    extra, check = FLAGS[flag]
    made = []
    real = engine.make_observers
    monkeypatch.setattr(engine, 'make_observers', lambda *a, **k: (
        made.append(real(*a, **k)) or made[-1]))
    res = module.train({**base, 'kfac_metrics': str(tmp_path / 'm.jsonl'),
                        'selfheal': True, **extra}, device='cpu')
    assert res['steps'] == 2 and res['rollbacks'] == []
    ctl = made[0].selfheal
    assert isinstance(ctl, selfheal.SelfHealController)
    assert check(ctl), vars(ctl.config)
    # Rung 1: the non-finite factor guard is armed with the ladder.
    assert res['state'].kfac.nonfinite_guard
    hyper = ctl.adjust_hyper({'damping': 0.003, 'lr': 0.1})
    assert ('bucket_gate' in hyper) == (flag != 'selfheal_no_quarantine')
    if 'bucket_gate' in hyper:
        assert set(hyper['bucket_gate']) == set(
            res['state'].kfac.metric_bucket_keys())


@pytest.mark.parametrize('cli', list(CONFIGS))
def test_selfheal_flag_rules(cli, tmp_path):
    module, base = CONFIGS[cli]
    with pytest.raises(SystemExit, match='--selfheal requires '
                                         '--kfac-metrics'):
        module.train({**base, 'selfheal': True}, device='cpu')
    with pytest.raises(SystemExit, match='requires the K-FAC step'):
        module.train({**base, 'selfheal': True, 'kfac_update_freq': 0,
                      'kfac_metrics': str(tmp_path / 'm.jsonl')},
                     device='cpu')
