"""The cadence backoff and the tuner of the torch port on 2 gloo ranks on
the CPU (one world, every run in turn).

  - Through the CIFAR CLI with ``--cadence-backoff`` under injected skew
    (rank 1's barrier waits read 100 ms, rank 0's 0 ms; the real probe's
    collective still runs): both ranks act on the world's largest wait, so
    both stretch at the same steps and run the same factor steps, and the
    world ends; rank 0's stream holds the ``autotune_backoff`` events.
  - An armed policy that sees no skew above its threshold: bit for bit the
    unarmed run (losses and every rank's parameters).
  - ``DistributedKFAC`` under an armed stretch against the deferred
    reduction, the stale schedule and gradient accumulation: each run
    equals, on every rank, the same steps driven with the policy's flags
    by hand.
  - ``tune`` under the group: every rank probes in lockstep and ends with
    the same artifact; rank 0 alone writes it, with the world 2/2.
"""

import json

import pytest

from distributed_kfac_pytorch_tpu_torch.observability import sink

from test_torch_stragglers_dist import run_ranks

STEPS = 6
WORLD = 2

WORKER = r'''
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from distributed_kfac_pytorch_tpu_torch import launch
from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as T
from distributed_kfac_pytorch_tpu_torch.autotune import driver, policy, probe
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine

TMP, STEPS = sys.argv[1], int(sys.argv[2])
out = {}
made = []
real = engine.make_observers
skew = {'on': False}


def make(*a, **k):
    obs = real(*a, **k)
    if skew['on'] and obs.barrier_probe is not None:
        probe_fn, rank = obs.barrier_probe, dist.get_rank()
        obs.barrier_probe = lambda: (probe_fn(), 100.0 * rank)[1]
    made.append(obs)
    return obs


engine.make_observers = make
base = {'model': 'resnet20', 'batch_size': 16, 'val_batch_size': 16,
        'synthetic_size': 16 * STEPS, 'epochs': 1, 'no_augment': True,
        'kfac_update_freq': 4, 'use_inv_kfac': True, 'quiet': True}


def run(name, **extra):
    res = T.train({**base, **extra}, device='cpu')
    return res, [p.detach().clone()
                 for p in res['state'].model.parameters()]


plain, plain_p = run('plain')
idle, idle_p = run('idle', cadence_backoff=True, backoff_skew_ms=1e9)
out['idle_equal'] = (plain['losses'] == idle['losses']
                     and all(torch.equal(a, b)
                             for a, b in zip(plain_p, idle_p)))
out['idle_stretch'] = made[-1].cadence_policy.stretch
out['idle_probe'] = made[-1].barrier_probe is not None
skew['on'] = True
armed, _ = run('armed', cadence_backoff=True, backoff_skew_ms=50.0,
               backoff_sustain_steps=2, backoff_recover_steps=64,
               kfac_metrics=TMP + '/armed.jsonl', metrics_interval=1)
skew['on'] = False
pol = made[-1].cadence_policy
out['armed'] = {'fired': armed['fired'], 'stretch': pol.stretch,
                'suppressed': pol.suppressed_firings,
                'factor_updates': int(
                    armed['state'].kfac_state['metrics']['factor_updates']),
                'losses': armed['losses']}

# DistributedKFAC under an armed stretch, against the schedule.
wl = probe.get_workload('tiny_mlp')
batches = [wl.make_batch(i % 4) for i in range(8)]
hyper = {'lr': 0.1, 'damping': 0.003, 'factor_update_freq': 1,
         'inv_update_freq': 4}
cfg = policy.BackoffConfig(skew_threshold_ms=5.0, sustain_steps=1,
                           max_stretch=4)


def state_of(knobs, accum):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = probe.TinyMLP()
    kfac = KFAC(model, inv_update_freq=4, factor_update_freq=1,
                collect_metrics=True, device='cpu', **knobs)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return engine.make_train_state(model, opt, kfac, grad_accum=accum)


cases = {'deferred': ({'deferred_factor_reduction': True}, 1),
         'staleness': ({'inv_staleness': 1}, 1), 'grad_accum': ({}, 2)}
out['engine'] = {}
for case, (knobs, accum) in cases.items():
    armed_s = state_of(knobs, accum)
    rank = dist.get_rank()
    obs = engine.Observers(cadence_policy=policy.StragglerCadencePolicy(cfg),
                           barrier_probe=lambda: 50.0 * rank)
    res = engine.train_epoch(armed_s, batches, hyper, device='cpu',
                             observers=obs)
    ref = state_of(knobs, accum)
    ref_pol = policy.StragglerCadencePolicy(cfg)
    schedule = engine.epoch_schedule(ref.kfac, 4)
    fired = []
    for step, (xb, yb) in enumerate(batches):
        flags = ref_pol.adjust(step, engine.cadence_flags(step, 1, 4,
                                                          **schedule), 50.0)
        fired.append(engine.fired_stage(flags))
        local = launch.process_local_slice(len(xb))
        engine.train_step(ref, torch.as_tensor(xb[local]),
                          torch.as_tensor(yb[local]), hyper, flags)
        ref.step += 1
    same = all(torch.equal(a, b) for a, b in
               zip(armed_s.model.parameters(), ref.model.parameters()))
    for key in ('factors', 'factor_accum', 'frozen_factors'):
        if key in ref.kfac_state:
            got, want = armed_s.kfac_state[key], ref.kfac_state[key]
            same = same and all(torch.equal(got[n][s], want[n][s])
                                for n in want for s in want[n])
    out['engine'][case] = {'fired': res['fired'], 'want': fired,
                           'same': same, 'stretch': obs.cadence_policy.stretch}

# The tuner under the group.
art = driver.tune('tiny_mlp', out=f'{TMP}/r{dist.get_rank()}.json',
                  steps=4, pruner='halving', device='cpu',
                  log=lambda *a: None,
                  space_overrides={'factor_batch_fraction': [1.0, 0.5],
                                   'kfac_cov_update_freq': [1, 2],
                                   'inv_pipeline_chunks': [1],
                                   'bf16_precond': [], 'kfac_approx': [],
                                   'deferred_factor_reduction': [],
                                   'inv_staleness': [],
                                   'inv_lowrank_rank': [],
                                   'fused_factor_contraction': [],
                                   'fused_precondition': []})
art.pop('created_unix')
out['tune'] = art
with open(f'{TMP}/rank{dist.get_rank()}.json', 'w') as f:
    json.dump(out, f)
'''


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('autotune_dist')
    code = ('import sys\n'
            f'sys.argv = ["worker", {str(tmp)!r}, "{STEPS}"]\n' + WORKER)
    run_ranks(WORLD, code)
    return tmp, [json.loads((tmp / f'rank{r}.json').read_text())
                 for r in range(WORLD)]


def test_skew_gives_every_rank_one_stretch(world):
    tmp, ranks = world
    armed = [r['armed'] for r in ranks]
    assert armed[0]['fired'] == armed[1]['fired']
    # Rank 0's own waits read 0 ms: it stretches on the world's largest.
    # Stretch 2 at step 1, 4 at step 3: steps 2-4 suppressed.
    assert armed[0]['stretch'] == armed[1]['stretch'] == 4
    assert armed[0]['suppressed'] == armed[1]['suppressed'] == 3
    assert armed[0]['factor_updates'] == armed[1]['factor_updates'] \
        == STEPS - 3
    assert armed[0]['fired'] == ['inverse', 'factor', None, None,
                                 'inverse', 'factor']
    assert armed[0]['losses'] == armed[1]['losses']
    events = [r.get('data', {}) for r in sink.read_jsonl(
        str(tmp / 'armed.jsonl')) if r['kind'] == 'event'
        and r['event'] == 'autotune_backoff']
    assert [(e['action'], e['stretch'], e['step']) for e in events] == \
        [('stretch', 2, 1), ('stretch', 4, 3)]
    assert events[0]['skew_ms'] == 100.0


def test_idle_policy_is_the_unarmed_run(world):
    _, ranks = world
    for r in ranks:
        assert r['idle_equal'] and r['idle_stretch'] == 1
        assert r['idle_probe']         # the flag arms the barrier probe


@pytest.mark.parametrize('case', ['deferred', 'staleness', 'grad_accum'])
def test_distributed_step_under_an_armed_stretch(world, case):
    _, ranks = world
    for r in ranks:
        got = r['engine'][case]
        assert got['fired'] == got['want']
        assert got['same'] and got['stretch'] == 4
    assert ranks[0]['engine'][case]['fired'] == \
        ranks[1]['engine'][case]['fired']


def test_tune_under_the_group_writes_one_artifact(world):
    tmp, ranks = world
    assert (tmp / 'r0.json').exists() and not (tmp / 'r1.json').exists()
    assert (tmp / 'r0.json.probe.jsonl').exists()
    assert not (tmp / 'r1.json.probe.jsonl').exists()
    arts = [r['tune'] for r in ranks]
    assert arts[0] == {**arts[1], 'probe': arts[0]['probe']}
    written = json.loads((tmp / 'r0.json').read_text())
    written.pop('created_unix')
    assert written == arts[0]
    assert arts[0]['topology']['topo_devices'] == WORLD
    assert arts[0]['topology']['topo_processes'] == WORLD
    assert arts[0]['platform'] == 'cpu'
    assert arts[0]['best_metrics']['n_steps'] == 4
