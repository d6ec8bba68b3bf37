"""The torch port's autotune probe and tuner on the CPU, against the JAX
package's.

The JAX probe of ``tiny_mlp`` runs once (4 recorded steps after two warm
windows at inverse cadence 4); the port's probe of the same workload on the
same numpy batches records the same steps with the same fired stages and
reduces them to the same gate-metric keys. (The JAX probe disqualifies
itself on its jax version for a retrace; its stream and metrics are still
written, and the port has no program variants: its probes count 0
retraces.) ``flagship_lm`` probes the JAX cadence too; every workload
draws the JAX workload's numpy batches. A step the kernel build labels
``'compile'`` is not scored, a candidate the constructor refuses is
``invalid:``, and ``tune`` writes an artifact with the committed
``TUNED_flagship_lm.json``'s keys that loads back on its own platform and
world, under each pruner.
"""

import json
from pathlib import Path

import pytest
import torch

import jax
from distributed_kfac_pytorch_tpu.autotune import driver as jdriver
from distributed_kfac_pytorch_tpu.autotune import probe as jprobe
from distributed_kfac_pytorch_tpu.parallel import distributed as D
from distributed_kfac_pytorch_tpu.training import engine as jengine
from distributed_kfac_pytorch_tpu.training import optimizers as joptim
from distributed_kfac_pytorch_tpu_torch.autotune import driver, probe
from distributed_kfac_pytorch_tpu_torch.observability import sink
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.training import optimizers

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / 'TUNED_flagship_lm.json'
STEPS = 4


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _steps(path) -> list:
    return [(r['step'], r.get('fired')) for r in sink.read_jsonl(str(path))
            if r['kind'] == 'step']


@pytest.fixture(scope='module')
def jax_probe(tmp_path_factory):
    """The JAX probe of tiny_mlp, once for the file."""
    stream = tmp_path_factory.mktemp('jax') / 'probe.jsonl'
    r = jprobe.probe_candidate(
        jprobe.get_workload('tiny_mlp'),
        joptim.OptimConfig(kfac_inv_update_freq=4), {}, steps=STEPS,
        mesh=D.make_kfac_mesh(jax.devices()[:1]), keep_stream=str(stream))
    return r, _steps(stream)


def test_probe_records_the_jax_steps(jax_probe, tmp_path):
    jr, jsteps = jax_probe
    stream = tmp_path / 'probe.jsonl'
    r = probe.probe_candidate(
        probe.get_workload('tiny_mlp'),
        optimizers.OptimConfig(kfac_inv_update_freq=4), {}, steps=STEPS,
        keep_stream=str(stream), device='cpu')
    assert _steps(stream) == jsteps == [(8, 'inverse'), (9, 'factor'),
                                        (10, 'factor'), (11, 'factor')]
    assert r.n_steps == jr.n_steps == STEPS
    assert set(r.metrics) == set(jr.metrics)
    assert set(r.to_row()) == set(jr.to_row())
    assert r.disqualified is None and r.retraces == 0
    assert r.nonfinite_skips == 0.0 and r.stream_path == str(stream)
    assert r.metrics['step_p50_ms'] > 0
    assert r.metrics['peak_hbm_bytes'] is None       # no allocator on CPU
    assert r.topology == {'topo_format': 1, 'topo_processes': 1,
                          'topo_devices': 1, 'topo_rows': 1, 'topo_cols': 1,
                          'topo_seq': 1, 'topo_slices': 1,
                          'topo_dist_factors': 0}
    records = sink.read_jsonl(str(stream))
    meta = records[0]['meta']
    assert (meta['autotune_probe'], meta['backend']) == ('tiny_mlp', 'cpu')
    # The memory records of the recorded segment (every inverse window).
    assert [x['step'] for x in records if x['kind'] == 'memory'] == [8]
    assert all('kfac/nonfinite_skips' in x['metrics']
               for x in records if x['kind'] == 'step')


@pytest.mark.parametrize('name', ['flagship_lm', 'cifar_resnet20',
                                  'tiny_mlp'])
def test_workloads_are_the_jax_workloads(name):
    wl, jwl = probe.get_workload(name), jprobe.get_workload(name)
    assert (wl.batch_size, wl.weight_shared, wl.max_factor_dim) == \
        (jwl.batch_size, jwl.weight_shared, jwl.max_factor_dim)
    # The same data: the LM's token windows, the images as NCHW.
    for i in (0, 3):
        x, y = wl.make_batch(i)
        jx, jy = jwl.make_batch(i)
        if name == 'cifar_resnet20':
            jx = jx.transpose(0, 3, 1, 2)
        assert (x == jx).all() and (y == jy).all()
    model = wl.make_model()
    dims = [d for m in model.modules()
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))
            for d in (m.weight[0].numel() + (m.bias is not None),
                      m.weight.shape[0])]
    # max_factor_dim: the largest dense factor side of the model (the JAX
    # figure counts a bias column on the bias-free convs too).
    assert wl.max_factor_dim - 1 <= max(dims) <= wl.max_factor_dim
    assert wl.lm == (name == 'flagship_lm')


def test_lm_workload_probes_the_jax_cadence(tmp_path):
    name, f_freq = 'flagship_lm', 2
    wl = probe.get_workload(name)
    stream = tmp_path / 'probe.jsonl'
    r = probe.probe_candidate(
        wl, optimizers.OptimConfig(kfac_inv_update_freq=4,
                                   kfac_cov_update_freq=f_freq), {},
        steps=STEPS, keep_stream=str(stream), device='cpu')
    want = []
    for step in range(8, 8 + STEPS):
        flags = jengine.cadence_flags(step, f_freq, 4)
        want.append((step, jengine.fired_stage(flags)))
    assert _steps(stream) == want
    assert r.disqualified is None and r.n_steps == STEPS


def test_compile_steps_are_not_scored(monkeypatch, tmp_path):
    """A kernel build during the recorded segment labels its plain step
    ``'compile'``; that step is left out of the score."""
    real = kernels.drain_build_events
    calls = []

    def drain():
        calls.append(1)
        out = real()
        # The first drain is the probe's, after its warm windows; then
        # one per recorded step: the third is step 9's, a plain step.
        if len(calls) == 3:
            out.append({'event': 'compile', 'kernel': 'factor_ema',
                        'seconds': 1.0})
        return out

    monkeypatch.setattr(kernels, 'drain_build_events', drain)
    stream = tmp_path / 'probe.jsonl'
    r = probe.probe_candidate(
        probe.get_workload('tiny_mlp'),
        optimizers.OptimConfig(kfac_inv_update_freq=4,
                               kfac_cov_update_freq=2), {}, steps=STEPS,
        keep_stream=str(stream), device='cpu')
    assert _steps(stream) == [(8, 'inverse'), (9, 'compile'),
                              (10, 'factor'), (11, None)]
    assert r.n_steps == STEPS - 1


def test_invalid_candidates_are_not_probed():
    base = optimizers.OptimConfig(kfac_inv_update_freq=4)
    wl = probe.get_workload('tiny_mlp')
    r = probe.probe_candidate(wl, base, {'inv_pipeline_chunks': 3},
                              device='cpu')
    assert r.disqualified.startswith('invalid: ')
    assert 'inv_pipeline_chunks' in r.disqualified
    assert r.metrics == {} and r.topology is None
    r = probe.probe_candidate(wl, base, {'bogus_knob': 1}, device='cpu')
    assert 'unknown knob' in r.disqualified
    r = probe.probe_candidate(wl, base, {'kfac_inv_update_freq': 0},
                              device='cpu')
    assert r.disqualified == 'invalid: candidate disables K-FAC ' \
                             '(kfac_inv_update_freq == 0)'
    with pytest.raises(ValueError, match='unknown workload'):
        probe.get_workload('resnet50')
    assert sorted(probe.WORKLOADS) == sorted(jprobe.WORKLOADS)


SPACE = {'factor_batch_fraction': [1.0, 0.5], 'kfac_cov_update_freq': [1, 2],
         'inv_pipeline_chunks': [1, 3], 'bf16_precond': [],
         'kfac_approx': [], 'deferred_factor_reduction': [],
         'inv_staleness': [], 'inv_lowrank_rank': [],
         'fused_factor_contraction': [], 'fused_precondition': []}


@pytest.mark.parametrize('pruner', ['full', 'halving', 'coordinate'])
def test_tune_writes_the_jax_artifact(pruner, tmp_path):
    out = tmp_path / 'TUNED_tiny_mlp.json'
    space = dict(SPACE)
    if pruner == 'full':
        space['inv_pipeline_chunks'] = [1]
    art = driver.tune('tiny_mlp', out=str(out), steps=STEPS,
                      pruner=pruner, space_overrides=space, device='cpu',
                      log=lambda *a: None)
    committed = json.loads(COMMITTED.read_text())
    assert set(art) == set(committed)
    assert json.loads(out.read_text()) == art
    assert set(art['probe']) == set(committed['probe'])
    assert art['probe']['pruner'] == pruner
    assert set(art['best']) == {'factor_batch_fraction',
                                'kfac_cov_update_freq',
                                'inv_pipeline_chunks'}
    assert art['best']['inv_pipeline_chunks'] == 1
    assert (art['platform'], art['workload']) == ('cpu', 'tiny_mlp')
    assert art['topology']['topo_devices'] == 1
    assert art['topology']['topo_processes'] == 1
    for row in art['candidates']:
        assert set(row) == set(committed['candidates'][0])
    # Chunks 3 does not divide the cadence: pruned before any probe.
    assert all(r['knobs']['inv_pipeline_chunks'] == 1
               for r in art['candidates'])
    assert all((r['score'] is None) == bool(r['disqualified'])
               for r in art['candidates'])
    assert art['best_metrics']['n_steps'] == STEPS
    assert art['self_check']['enabled']
    assert set(art['self_check']) >= {'enabled', 'pass'}
    assert Path(art['probe']['stream']).exists()
    # It loads back, fail-closed, on its own platform and world only: the
    # port's loader and the JAX package's alike.
    for load in (driver.load_tuned_config, jdriver.load_tuned_config):
        knobs, events = load(str(out), platform='cpu',
                             world={'devices': 1, 'processes': 1})
        assert knobs == art['best']
        assert events[0]['event'] == 'autotune_apply'
        knobs, events = load(str(out), platform='gpu',
                             world={'devices': 1, 'processes': 1})
        assert knobs is None and events[0]['reason'] == 'platform_mismatch'


def test_tune_commits_nothing_when_every_candidate_fails(tmp_path):
    with pytest.raises(SystemExit, match='every candidate was disqualified'):
        driver.tune('tiny_mlp', out=str(tmp_path / 'x.json'), steps=2,
                    pruner='full', device='cpu', log=lambda *a: None,
                    space_overrides={**SPACE, 'inv_pipeline_chunks': [3],
                                     'factor_batch_fraction': [1.0],
                                     'kfac_cov_update_freq': [1]})
    assert not (tmp_path / 'x.json').exists()


def test_the_driver_lists_the_jax_candidates(capsys):
    argv = ['--list', '--inv-update-freq', '4', '--set',
            'inv_pipeline_chunks=1,2,3', '--set', 'kfac_approx=',
            '--set', 'fused_precondition=true']
    assert driver.main(argv) == 0
    ours = capsys.readouterr().out
    assert jdriver.main(argv) == 0
    assert ours == capsys.readouterr().out and ours.count('\n') > 8
