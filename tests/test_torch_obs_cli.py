"""The observability stream of the torch port on the CPU: the JSONL sink,
the health monitor, the report and the CLIs' ``--log-dir``,
``--kfac-metrics``, ``--metrics-interval`` and ``--health-action``,
against the JAX package's readers.

  - the sink: schema-valid records (the JAX ``validate_record`` too),
    interval thinning, rotation, the incarnation chain, rank gating, and
    the snapshot rule: a kept record holds its step's values even when
    the tensors it was given change in place afterwards; non-finite
    values ride as strings;
  - the health monitor: the same events as JAX's on one record stream,
    and the warn / skip / raise actions (raise after the records are on
    disk);
  - the CIFAR CLI at tiny width with ``--kfac-metrics``: its stream read
    by the JAX ``report --json`` and ``gate``, the port's ``report
    --json`` (and text) byte for byte equal to JAX's on the same file, one
    step record per step with the ``kfac/*`` metrics, and TensorBoard
    scalars under ``--log-dir``; the ImageNet and LM CLIs write a stream
    the same way; the flags' ``SystemExit`` rules;
  - ``KFAC_CHAOS=nan-batch@2`` with ``--health-action warn``: the
    ``nonfinite`` health event at step 2; under ``--fp16`` an overflow
    step's record keeps the counters of the step before, with
    ``overflow`` and ``loss_scale``; ``preempt@3`` then the relaunch:
    ``checkpoint_save``, ``preemption`` and ``restore`` events with the
    JAX fields, the dead incarnation kept as ``.prev.1``;
  - a kernel build pending after a plain step: a ``compile`` event and the
    step labelled ``'compile'``, read by the JAX report's compile
    section;
  - the straggler readers on rank shards, and the report on a stream of
    every event kind, equal to JAX's.
"""

import contextlib
import io
import json
import math
import struct
import warnings

import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu.observability import gate as jgate
from distributed_kfac_pytorch_tpu.observability import health as jhealth
from distributed_kfac_pytorch_tpu.observability import report as jreport
from distributed_kfac_pytorch_tpu.observability import sink as jsink
from distributed_kfac_pytorch_tpu.observability import \
    stragglers as jstragglers
from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cifar
from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet as inet
from distributed_kfac_pytorch_tpu_torch import train_language_model as lm
from distributed_kfac_pytorch_tpu_torch.observability import health, \
    report, sink, stragglers
from distributed_kfac_pytorch_tpu_torch.ops import kernels
from distributed_kfac_pytorch_tpu_torch.training import engine

TINY = {'model': 'resnet20', 'batch_size': 8, 'val_batch_size': 4,
        'synthetic_size': 32, 'epochs': 1, 'no_augment': True,
        'kfac_update_freq': 2, 'quiet': True}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stdout(fn, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


# ---------------------------------------------------------------------------
# The sink
# ---------------------------------------------------------------------------

def test_sink_schema_interval_and_snapshot(tmp_path):
    path = tmp_path / 'm.jsonl'
    s = sink.JsonlMetricsSink(str(path), interval=3, meta={'cli': 'x'})
    live = torch.zeros((), dtype=torch.float32)
    counter = torch.zeros((), dtype=torch.int32)
    for step in range(7):
        live.fill_(float(step) + 0.5)
        counter += 1
        s.step_record(step, {'loss': live, 'kfac/factor_updates': counter,
                             'overflow': False, 'lr': 0.1},
                      host_step_ms=1.5, fired='factor' if step else None)
        # Changed in place after the record: the record must not see it.
        live.fill_(-1.0)
        counter += 100
    s.epoch_record(0, {'loss': float('nan'), 'acc': 0.25})
    s.event_record('restore', source='step', label=3)
    s.close()
    recs = sink.read_jsonl(str(path))
    assert jsink.read_jsonl(str(path)) == recs
    for r in recs:
        jsink.validate_record(r)
    steps = [r for r in recs if r['kind'] == 'step']
    assert [r['step'] for r in steps] == [0, 3, 6]
    assert [r['metrics']['loss'] for r in steps] == [0.5, 3.5, 6.5]
    assert [r['metrics']['kfac/factor_updates'] for r in steps] == [
        1.0, 304.0, 607.0]
    assert steps[0]['metrics']['overflow'] == 0.0
    assert 'fired' not in steps[0] and steps[1]['fired'] == 'factor'
    assert steps[0]['host_step_ms'] == 1.5
    epoch = next(r for r in recs if r['kind'] == 'epoch')
    assert epoch['metrics'] == {'loss': 'nan', 'acc': 0.25}
    assert [r['kind'] for r in recs] == ['meta', 'step', 'step', 'step',
                                         'epoch', 'event']


def test_sink_rotation_incarnations_and_rank_gating(tmp_path):
    path = str(tmp_path / 'r.jsonl')
    s = sink.JsonlMetricsSink(path, rotate_bytes=400, drain_every=2)
    for step in range(12):
        s.step_record(step, {'loss': torch.tensor(float(step))})
    s.close()
    assert sink._rotated_segments(path)
    assert [r['step'] for r in sink.read_jsonl(path)] == list(range(12))
    # A relaunch at the same path chains the dead run, segments included.
    s2 = sink.JsonlMetricsSink(path, meta={'run': 2})
    s2.close()
    assert sink.incarnation_paths(path) == [f'{path}.prev.1']
    assert len(sink.read_incarnation(f'{path}.prev.1')) == 12
    assert [r['kind'] for r in sink.read_jsonl(path)] == ['meta']
    assert jsink.incarnation_paths(path) == sink.incarnation_paths(path)
    # Rank gating: a non-zero rank writes nothing.
    other = tmp_path / 'rank1.jsonl'
    s3 = sink.JsonlMetricsSink(str(other), process_index=1, meta={})
    s3.step_record(0, {'loss': 1.0})
    s3.event_record('preemption', global_step=0)
    s3.close()
    assert not other.exists()


def test_sink_registries_match_jax():
    assert sink.SCHEMA_VERSION == jsink.SCHEMA_VERSION == 4
    assert sink.RECORD_KINDS == jsink.RECORD_KINDS
    assert sink.EVENT_KINDS == jsink.EVENT_KINDS
    assert sink.ACCEPTED_SCHEMAS == jsink.ACCEPTED_SCHEMAS


# ---------------------------------------------------------------------------
# The health monitor
# ---------------------------------------------------------------------------

def _health_stream() -> list:
    recs = []
    for step in range(30):
        m = {'loss': 1.0, 'kfac/damping': 0.003,
             'kfac/factor_updates': float(min(step, 5) + 1),
             'kfac/nonfinite_skips': float(step >= 20),
             'kfac/eig_clipped': float(3 if step >= 25 else 0),
             'kfac/grad_norm': 'nan' if step == 22 else 1.0}
        if step == 27:
            m['kfac/damping'] = 0.3
        recs.append({'schema': 4, 'kind': 'step', 'step': step,
                     'wall_time': 0.0, 'host_step_ms':
                     (500.0 if step == 24 else 10.0 + 0.01 * step),
                     'metrics': m})
    for i in range(9):
        recs.append({'schema': 4, 'kind': 'memory', 'step': 30 + i,
                     'wall_time': 0.0,
                     'device': {'bytes_in_use': 1000 * (1 + i)}})
    return recs


def test_health_monitor_events_match_jax():
    kw = dict(stale_after_steps=10, step_spike_zscore=8.0,
              memory_growth_windows=6)
    mine = health.HealthMonitor('skip', **kw)
    theirs = jhealth.HealthMonitor('skip', **kw)
    for r in _health_stream():
        mine.observe(r)
        theirs.observe(r)
    assert mine.events == theirs.events and mine.events
    assert mine.summary() == theirs.summary()
    assert set(mine.summary()['by_kind']) == {
        'nonfinite', 'factor_stale', 'damping', 'eig_floor', 'step_spike',
        'memory_growth'}


def test_health_actions(tmp_path):
    bad = {'loss': torch.tensor(float('nan'))}
    with pytest.warns(RuntimeWarning, match='non-finite loss'):
        s = sink.JsonlMetricsSink(str(tmp_path / 'w.jsonl'),
                                  monitor=health.HealthMonitor('warn'))
        s.step_record(0, bad)
        s.close()
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        mon = health.HealthMonitor('skip')
        s = sink.JsonlMetricsSink(str(tmp_path / 's.jsonl'), monitor=mon)
        s.step_record(0, bad)
        s.close()
    assert len(mon.events) == 1
    path = tmp_path / 'r.jsonl'
    s = sink.JsonlMetricsSink(str(path), monitor=health.HealthMonitor(
        'raise'))
    s.step_record(0, {'loss': torch.tensor(1.0)})
    s.step_record(1, bad)
    with pytest.raises(health.HealthError, match='step 1'):
        s.flush()
    # The records were written before the action fired.
    assert [r['step'] for r in sink.read_jsonl(str(path))] == [0, 1]
    with pytest.raises(ValueError, match='action'):
        health.HealthMonitor('ignore')


# ---------------------------------------------------------------------------
# The CLIs' stream, read by the JAX report and gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def cifar_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('cifar_metrics')
    path = tmp / 'logs' / 'kfac_metrics.jsonl'
    res = cifar.train({**TINY, 'kfac_metrics': 'auto', 'metrics_interval': 1,
                       'health_action': 'warn', 'log_dir': str(tmp / 'logs')},
                      device='cpu')
    return {'res': res, 'path': path, 'tmp': tmp}


def test_cli_stream_records(cifar_run):
    res, path = cifar_run['res'], cifar_run['path']
    recs = sink.read_jsonl(str(path))
    steps = [r for r in recs if r['kind'] == 'step']
    assert [r['step'] for r in steps] == list(range(res['steps']))
    assert [r.get('fired') for r in steps] == res['fired']
    metas = [r['meta'] for r in recs if r['kind'] == 'meta']
    assert metas[0] == {'cli': 'train_cifar10_resnet', 'model': 'resnet20',
                        'batch_size': 8, 'devices': 1, 'metrics_interval': 1}
    assert set(metas[1]) == {'kfac_approx', 'kfac_approx_setting',
                             'tied_embeddings'}
    kfac = res['state'].kfac
    keys = {f'kfac/bucket_norm/{k}' for k in kfac.metric_bucket_keys()}
    for i, r in enumerate(steps):
        m = r['metrics']
        assert keys <= set(m) and {'loss', 'acc', 'kfac/nu'} <= set(m)
        assert m['kfac/factor_updates'] == i + 1
        assert m['loss'] == pytest.approx(res['losses'][i], rel=1e-6)
        assert r['host_step_ms'] > 0
    epoch = [r for r in recs if r['kind'] == 'epoch']
    assert len(epoch) == 1 and {'time_s', 'ms_per_iter', 'loss',
                                'kfac/nu'} <= set(epoch[0]['metrics'])
    assert {k for k in res['train'] if k.startswith('kfac/')} >= keys


def test_port_report_equals_jax_report(cifar_run):
    path = str(cifar_run['path'])
    for extra in (['--json'], []):
        rc, mine = _stdout(report.main, [path, *extra])
        jrc, theirs = _stdout(jreport.main, [path, *extra])
        assert rc == jrc == 0
        assert mine == theirs
    summary = json.loads(_stdout(report.main, [path, '--json'])[1])
    res = cifar_run['res']
    assert summary['n_steps'] == res['steps']
    assert summary['kfac']['factor_updates'] == res['steps']
    assert summary['health_events'] == []


def test_jax_gate_reads_the_port_stream(cifar_run):
    path = str(cifar_run['path'])
    base = str(cifar_run['tmp'] / 'baseline.json')
    rc, out = _stdout(jgate.main, [path, '--write-baseline', base])
    assert rc == 0, out
    rc, out = _stdout(jgate.main, [path, '--baseline', base, '--json',
                                   '--allow-missing'])
    verdict = json.loads(out)
    assert rc == 0 and verdict['pass'], verdict
    assert verdict['current']['step_p50_ms'] > 0


def _scalars(log_dir) -> dict:
    """``{tag: [(step, value)]}`` of the TensorBoard event files in
    ``log_dir``, parsed from the record framing (length, crc, data,
    crc)."""
    from tensorboard.compat.proto import event_pb2
    out: dict = {}
    for f in sorted(log_dir.glob('events.out.tfevents.*')):
        data = f.read_bytes()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack('<Q', data[pos:pos + 8])
            ev = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in ev.summary.value:
                out.setdefault(v.tag, []).append((ev.step, v.simple_value))
    return out


def test_log_dir_gets_tensorboard_scalars(cifar_run, monkeypatch):
    pytest.importorskip('tensorboard')
    got = _scalars(cifar_run['tmp'] / 'logs')
    res = cifar_run['res']
    assert got['train/loss'] == [(0, pytest.approx(res['train']['loss'],
                                                    rel=1e-6))]
    assert got['val/acc'][0][0] == 0 and 'train/kfac/nu' in got
    # Without tensorboard the writer is a no-op, as JAX's without tf.
    import sys
    monkeypatch.setitem(sys.modules, 'tensorboard.compat.proto', None)
    off = cifar_run['tmp'] / 'off'
    w = engine.TensorBoardWriter(str(off))
    w.scalar('a', 1.0, 0)
    w.epoch(0, {'loss': 1.0}, {})
    w.close()
    assert not off.exists()


@pytest.mark.parametrize('module,config', [
    (inet, {'model': 'resnet18', 'image_size': 32, 'batch_size': 4,
            'val_batch_size': 2, 'synthetic_size': 8, 'epochs': 1,
            'inverse_method': 'cholesky', 'kfac_update_freq': 2,
            'kfac_cov_update_freq': 1, 'max_steps': 2, 'quiet': True,
            'skip_layers': ['layer3_block0', 'layer3_block1',
                            'layer4_block0', 'layer4_block1']}),
    (lm, {'emsize': 12, 'nhid': 12, 'synthetic_vocab': 40,
          'synthetic_size': 2000, 'bptt': 4, 'batch_size': 3,
          'max_steps': 3, 'epochs': 1, 'inverse_method': 'eigen',
          'kfac_update_freq': 2, 'quiet': True})],
    ids=['imagenet', 'lm'])
def test_imagenet_and_lm_clis_write_the_stream(tmp_path, module, config):
    path = tmp_path / 'm.jsonl'
    res = module.train({**config, 'kfac_metrics': str(path),
                        'metrics_interval': 1, 'health_action': 'skip'},
                       device='cpu')
    assert res['state'].kfac.nonfinite_guard       # skip arms the guard
    recs = sink.read_jsonl(str(path))
    steps = [r for r in recs if r['kind'] == 'step']
    assert len(steps) == res['steps']
    assert all(r['metrics']['kfac/nonfinite_skips'] == 0 for r in steps)
    cli = recs[0]['meta']['cli']
    assert cli == module.__name__.rsplit('.', 1)[1]
    assert _stdout(report.main, [str(path), '--json'])[1] == _stdout(
        jreport.main, [str(path), '--json'])[1]


@pytest.mark.parametrize('module', [cifar, inet, lm],
                         ids=['cifar', 'imagenet', 'lm'])
def test_cli_flag_rules(module, tmp_path):
    args = module.build_parser().parse_args([])
    assert (args.kfac_metrics, args.metrics_interval,
            args.health_action) == (None, 10, None)
    name = {cifar: 'cifar10', inet: 'imagenet', lm: 'lm'}[module]
    assert args.log_dir == f'./logs/{name}'
    assert module.build_parser().parse_args(
        ['--kfac-metrics']).kfac_metrics == 'auto'
    with pytest.raises(SystemExit, match='--health-action requires'):
        module.train({'health_action': 'warn'}, device='cpu')
    with pytest.raises(SystemExit, match='requires the K-FAC step'):
        module.train({'kfac_metrics': str(tmp_path / 'm.jsonl'),
                      'kfac_update_freq': 0}, device='cpu')
    with pytest.raises(SystemExit, match='--log-dir'):
        module.train({'kfac_metrics': 'auto'}, device='cpu')


# ---------------------------------------------------------------------------
# Faults and resilience events
# ---------------------------------------------------------------------------

def test_nan_batch_gives_the_nonfinite_health_event(tmp_path, monkeypatch):
    monkeypatch.setenv('KFAC_CHAOS', 'nan-batch@2')
    path = tmp_path / 'm.jsonl'
    with pytest.warns(RuntimeWarning, match='KFAC health: step 2'):
        cifar.train({**TINY, 'kfac_update_freq': 10, 'max_steps': 3,
                     'kfac_metrics': str(path), 'metrics_interval': 1,
                     'health_action': 'warn'}, device='cpu')
    summary = json.loads(_stdout(report.main, [str(path), '--json'])[1])
    events = summary['health_events']
    assert events and all(e.startswith('step 2') for e in events)
    assert summary['health_event_counts'] == {'nonfinite': len(events)}
    recs = [r for r in sink.read_jsonl(str(path)) if r['kind'] == 'step']
    assert recs[2]['metrics']['kfac/nonfinite_skips'] == 1.0
    assert recs[2]['metrics']['loss'] == 'nan'


def test_fp16_overflow_step_keeps_the_counters(tmp_path, monkeypatch):
    """Under ``--fp16`` a step skipped on overflow runs no K-FAC step, so
    its record carries the counters of the step before (JAX selects the
    old state, metrics included), ``overflow`` 1 and the scale it used."""
    monkeypatch.setenv('KFAC_CHAOS', 'nan-batch@1')
    path = tmp_path / 'm.jsonl'
    res = cifar.train({**TINY, 'batch_size': 2, 'val_batch_size': 2,
                       'synthetic_size': 8, 'use_inv_kfac': True,
                       'max_steps': 3, 'fp16': True,
                       'kfac_metrics': str(path), 'metrics_interval': 1},
                      device='cpu')
    steps = [r['metrics'] for r in sink.read_jsonl(str(path))
             if r['kind'] == 'step']
    scaler = res['scaler']
    assert [s['overflow'] for s in scaler] == [False, True, False]
    assert [m['overflow'] for m in steps] == [0.0, 1.0, 0.0]
    assert [m['loss_scale'] for m in steps] == [s['scale'] for s in scaler]
    for key in ('kfac/factor_updates', 'kfac/inv_updates', 'kfac/nu',
                'kfac/grad_norm'):
        assert steps[1][key] == steps[0][key], key
    assert steps[2]['kfac/factor_updates'] == 2.0


def test_preemption_and_resume_events(tmp_path, monkeypatch):
    path = tmp_path / 'm.jsonl'
    config = {**TINY, 'checkpoint_dir': str(tmp_path / 'ck'),
              'checkpoint_steps': 2, 'kfac_metrics': str(path),
              'metrics_interval': 1}
    monkeypatch.setenv('KFAC_CHAOS', 'preempt@3')
    res = cifar.train(config, device='cpu')
    assert res['preempted']['global_step'] == 3
    monkeypatch.delenv('KFAC_CHAOS')
    cifar.train(config, device='cpu')
    dead = sink.read_incarnation(f'{path}.prev.1')
    events = [(r['event'], r['data']) for r in dead if r['kind'] == 'event']
    names = [e for e, _ in events]
    assert names == ['checkpoint_save', 'checkpoint_save', 'preemption']
    save, forced, pre = (d for _, d in events)
    assert save['global_step'] == 2 and not save['forced']
    assert forced['global_step'] == 3 and forced['forced']
    assert set(save) == {'global_step', 'step_in_epoch', 'latency_ms',
                         'blocking', 'forced'}
    assert pre['global_step'] == 3 and pre['reason'] == \
        'injected preemption' and 'grace_remaining_s' in pre
    live = sink.read_jsonl(str(path))
    restore = [r['data'] for r in live if r.get('event') == 'restore']
    assert restore == [{'source': 'step', 'label': 3, 'global_step': 3,
                        'epoch': 0, 'step_in_epoch': 3}]
    assert [r['step'] for r in live if r['kind'] == 'step'] == [3]
    summary = json.loads(_stdout(jreport.main, [str(path), '--json'])[1])
    assert summary['event_counts']['restore'] == 1


# ---------------------------------------------------------------------------
# Compile events, shards, every event kind
# ---------------------------------------------------------------------------

def test_kernel_build_becomes_a_compile_event(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, '_BUILD_EVENTS', [{
        'event': 'compile', 'variant': 'kernels', 'libraries':
        'factor_ema,patch_cov', 'built': 2, 'first_call_ms': 31000.0}])
    path = str(tmp_path / 'c.jsonl')
    s = sink.JsonlMetricsSink(path)
    engine.record_step(s, 0, {'loss': torch.tensor(1.0)}, 31500.0, None)
    engine.record_step(s, 1, {'loss': torch.tensor(1.0)}, 10.0, 'factor')
    s.close()
    recs = sink.read_jsonl(path)
    assert [r.get('fired') for r in recs if r['kind'] == 'step'] == [
        'compile', 'factor']
    assert kernels.drain_build_events() == []
    summary = json.loads(_stdout(jreport.main, [path, '--json'])[1])
    assert summary['compiles'] == [{'variant': 'kernels', 'libraries':
                                    'factor_ema,patch_cov', 'built': 2,
                                    'first_call_ms': 31000.0}]
    assert _stdout(report.main, [path])[1] == _stdout(jreport.main,
                                                      [path])[1]


def test_straggler_readers_match_jax(tmp_path):
    base = tmp_path / 'run.jsonl'
    sink.JsonlMetricsSink(str(base)).close()
    rng = np.random.default_rng(9)
    for rank in range(3):
        s = sink.JsonlMetricsSink(stragglers.rank_shard_path(str(base),
                                                             rank),
                                  meta={'rank': rank, 'slice': rank // 2})
        for step in range(6):
            s.step_record(step, {stragglers.BARRIER_WAIT_KEY:
                                 float(rng.random())},
                          host_step_ms=float(10 + rng.random()),
                          fired=('reduce', None, 'inverse')[step % 3])
        s.close()
    assert stragglers.find_shards(str(base)) == jstragglers.find_shards(
        str(base))
    shards, torn, errors = stragglers.merge_shards(str(base))
    jshards, jtorn, jerrors = jstragglers.merge_shards(str(base))
    assert (shards, torn, errors) == (jshards, jtorn, jerrors)
    assert stragglers.straggler_summary(shards) == \
        jstragglers.straggler_summary(jshards)
    for fired in ('inverse+dcn_reduce', 'reduce', 'factor', 'chunk1',
                  'compile', None):
        assert stragglers.stage_class(fired) == jstragglers.stage_class(
            fired)
    assert _stdout(report.main, [str(base)])[1] == _stdout(
        jreport.main, [str(base)])[1]


def test_report_equals_jax_on_every_event_kind(tmp_path):
    path = str(tmp_path / 'all.jsonl')
    s = sink.JsonlMetricsSink(path, meta={'cli': 'x'})
    for i, name in enumerate(sink.EVENT_KINDS):
        s.event_record(name, global_step=i, job=f'j{i % 2}', action=(
            'stretch' if i % 2 else 'relax'), variant='v', trace_count=2,
                       first_call_ms=1.5, latency_ms=2.0 + i, outcome='x',
                       rc=0, queue_wait_s=1.0, run_s=2.0, restarts=0,
                       preemptions=1)
    s.memory_record(5, device={'bytes_in_use': 1 << 30,
                               'peak_bytes_in_use': 3 << 29},
                    state={'total_bytes': 1 << 20,
                           'by_group_dtype': {'factors/float32': 1 << 20}})
    for step in range(4):
        s.step_record(step, {'loss': torch.tensor(2.0 - step),
                             'kfac/grad_norm': torch.tensor(1.0),
                             'kfac/precond_norm': torch.tensor(0.5)},
                      host_step_ms=10.0 + step * math.pi)
    s.epoch_record(0, {'loss': 1.0}, trace={'train_step_dispatch': {
        'mean_ms': 1.0, 'total_ms': 4.0, 'count': 4}})
    s.close()
    for extra in (['--json'], []):
        assert _stdout(report.main, [path, *extra]) == _stdout(
            jreport.main, [path, *extra])
    assert report.format_bytes(3 << 29) == '1.50 GiB'
