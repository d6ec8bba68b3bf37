"""The port's regression gate (``observability.gate``) against the JAX
package's, on the same streams:

  - ``gate_metrics`` equal on JAX's own fixture streams (every schema
    version, the torn tail, the committed baseline's source stream), on
    synthetic streams of each failure kind, and on a stream the port's
    CIFAR CLI writes on the CPU (memory records, a self-healing rollback
    event);
  - ``compare`` and ``anomaly_events`` equal on the same vectors and
    streams;
  - ``main``: the same exit codes and the same ``--json`` verdict for a
    matrix of baselines, tolerances and flags;
  - each gate reads the baselines the other writes, and the committed
    ``BASELINE_OBS.json``.
"""

import contextlib
import io
import json
import pathlib

import pytest
import torch

from distributed_kfac_pytorch_tpu.observability import gate as jgate
from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cifar
from distributed_kfac_pytorch_tpu_torch.observability import gate, sink

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / 'tests' / 'fixtures'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, buf.getvalue()


def _write_run(path, n=40, base_ms=10.0, spike_at=None, mem_growth=False,
               events=()):
    """A synthetic stream through the port's sink (JAX's gate-test
    shape)."""
    s = sink.JsonlMetricsSink(str(path), meta={'run': 'gate'})
    for i in range(n):
        ms = base_ms + 0.01 * (i % 5)
        if spike_at is not None and i == spike_at:
            ms = base_ms * 2.0
        s.step_record(i, {'loss': 1.0}, host_step_ms=ms,
                      fired='inverse' if i % 10 == 0 else None)
        if i % 4 == 0:
            grow = 100 * (i // 4) if mem_growth else 0
            s.memory_record(i, device={'bytes_in_use': 1000 + grow,
                                       'peak_bytes_in_use': 2000 + grow})
    for name in events:
        s.event_record(name, from_step=5, to_step=2, label=2)
    s.close()
    return str(path)


FIXTURE_STREAMS = ['metrics_v1.jsonl', 'metrics_v2.jsonl',
                   'metrics_v3.jsonl', 'metrics_v4.jsonl',
                   'torn_tail.jsonl']


@pytest.mark.parametrize('name', FIXTURE_STREAMS + ['baseline_source'])
def test_gate_metrics_equal_on_jax_fixtures(name):
    path = (ROOT / 'BASELINE_OBS.json.source.jsonl'
            if name == 'baseline_source' else FIXTURES / name)
    records, torn = sink.read_jsonl_tolerant(str(path))
    jrecords, jtorn = jgate.read_jsonl_tolerant(str(path))
    assert (records, torn) == (jrecords, jtorn)
    assert gate.gate_metrics(records) == jgate.gate_metrics(records)


SYNTHETIC = {'clean': {}, 'spike': {'spike_at': 30},
             'slow': {'base_ms': 20.0}, 'leaky': {'mem_growth': True},
             'events': {'events': ('retrace', 'selfheal_rollback',
                                   'supervisor_restart',
                                   'fleet_quarantine')}}


@pytest.mark.parametrize('kind', list(SYNTHETIC))
def test_metrics_and_anomalies_equal_on_port_streams(tmp_path, kind):
    path = _write_run(tmp_path / f'{kind}.jsonl', **SYNTHETIC[kind])
    records = sink.read_jsonl(path)
    cur = gate.gate_metrics(records)
    assert cur == jgate.gate_metrics(records)
    assert gate.anomaly_events(records) == jgate.anomaly_events(records)
    if kind == 'events':
        assert (cur['retraces'], cur['selfheal_rollbacks'],
                cur['supervisor_restarts'],
                cur['fleet_quarantines']) == (1, 1, 1, 1)


@pytest.mark.parametrize('current,tols,allow', [
    ({'step_p50_ms': 11.5, 'retraces': 0}, None, False),
    ({'step_p50_ms': 10.5, 'peak_hbm_bytes': None}, None, False),
    ({'step_p50_ms': 10.5, 'peak_hbm_bytes': None}, None, True),
    ({'selfheal_rollbacks': 1, 'step_p95_ms': 12.0},
     {'step_p95_ms': 0.3}, False)],
    ids=['p50-breach', 'missing', 'allow-missing', 'counts-and-tol'])
def test_compare_equal(current, tols, allow):
    base = {'step_p50_ms': 10.0, 'step_p95_ms': 10.0, 'step_p99_ms': 10.0,
            'peak_hbm_bytes': 2000, 'retraces': 0,
            'selfheal_rollbacks': 0}
    full = {**{k: v for k, v in base.items()}, **current}
    assert gate.compare(full, base, tols, allow_missing=allow) == \
        jgate.compare(full, base, tols, allow_missing=allow)


def _matrix(tmp_path):
    """(stream, argv tail) cases over one clean baseline."""
    clean = _write_run(tmp_path / 'clean.jsonl')
    base = str(tmp_path / 'base.json')
    jgate.write_baseline(jgate.gate_metrics(sink.read_jsonl(clean)), base)
    return clean, base


MAIN_CASES = {
    'self-pass': ('clean', []),
    'spike': ('spike', []),
    'spike-no-anomaly': ('spike', ['--no-anomaly']),
    'slow': ('slow', []),
    'slow-tol': ('slow', ['--tol', 'step_p50_ms=1.5', '--tol',
                          'step_p95_ms=1.5', '--tol', 'step_p99_ms=1.5']),
    'leaky': ('leaky', []),
    'events': ('events', []),
    'bogus-tol': ('clean', ['--tol', 'bogus=1.0']),
    'json': ('spike', ['--json']),
}


@pytest.mark.parametrize('case', list(MAIN_CASES))
def test_main_exit_codes_and_verdicts_equal(tmp_path, case):
    kind, extra = MAIN_CASES[case]
    _, base = _matrix(tmp_path)
    path = _write_run(tmp_path / f'{kind}_run.jsonl', **SYNTHETIC[kind])
    argv = [path, '--baseline', base, *extra]
    rc, out = _run(gate.main, argv)
    jrc, jout = _run(jgate.main, argv)
    assert rc == jrc
    assert rc == (0 if case in ('self-pass', 'slow-tol')
                  else 2 if case == 'bogus-tol' else 1)
    if case == 'json':
        assert json.loads(out) == json.loads(jout)
    else:
        # The text verdicts match line for line.
        assert out.splitlines() == jout.splitlines()


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_each_gate_reads_the_others_baseline(tmp_path, writer):
    path = _write_run(tmp_path / 'run.jsonl')
    base = str(tmp_path / 'b.json')
    w_main, r_main = ((gate.main, jgate.main) if writer == 'port'
                      else (jgate.main, gate.main))
    rc, _ = _run(w_main, [path, '--write-baseline', base])
    assert rc == 0
    obj = json.load(open(base))
    assert obj['format'] == gate.BASELINE_FORMAT == jgate.BASELINE_FORMAT
    assert gate.read_baseline(base)['metrics'] == \
        jgate.read_baseline(base)['metrics']
    assert _run(r_main, [path, '--baseline', base])[0] == 0
    slow = _write_run(tmp_path / 'slow.jsonl', base_ms=20.0)
    assert _run(r_main, [slow, '--baseline', base])[0] == 1


def test_committed_baseline_and_read_errors(tmp_path):
    base = str(ROOT / 'BASELINE_OBS.json')
    assert gate.read_baseline(base) == jgate.read_baseline(base)
    src = str(ROOT / 'BASELINE_OBS.json.source.jsonl')
    for argv in ([src, '--baseline', base, '--json'],
                 [str(tmp_path / 'missing.jsonl')],
                 [src, '--baseline', str(tmp_path / 'missing.json')]):
        (rc, out), (jrc, jout) = _run(gate.main, argv), _run(jgate.main,
                                                             argv)
        assert rc == jrc
        if '--json' in argv:
            assert json.loads(out) == json.loads(jout)
    bad = tmp_path / 'bad.json'
    bad.write_text(json.dumps({'format': 'other', 'metrics': {}}))
    with pytest.raises(ValueError, match='kfac-obs-baseline-v1'):
        gate.read_baseline(str(bad))


def test_gate_on_a_port_cli_stream(tmp_path):
    """The CIFAR CLI's stream (memory records every step, an epoch record
    with the trace table): equal metrics, a self-baseline passes in both
    gates, a rollback event added breaches both (absolute count)."""
    path = tmp_path / 'm.jsonl'
    cifar.train({'model': 'resnet20', 'batch_size': 8, 'val_batch_size': 4,
                 'synthetic_size': 24, 'epochs': 1, 'no_augment': True,
                 'kfac_update_freq': 2, 'quiet': True,
                 'kfac_metrics': str(path), 'metrics_interval': 1,
                 'memory_interval': 1}, device='cpu')
    records = sink.read_jsonl(str(path))
    kinds = [r['kind'] for r in records]
    assert kinds.count('memory') == 3 and kinds.count('step') == 3
    assert 'train_step_dispatch' in next(
        r for r in records if r['kind'] == 'epoch')['trace']
    assert gate.gate_metrics(records) == jgate.gate_metrics(records)
    base = str(tmp_path / 'b.json')
    assert _run(gate.main, [str(path), '--write-baseline', base])[0] == 0
    for main in (gate.main, jgate.main):
        assert _run(main, [str(path), '--baseline', base,
                           '--no-anomaly'])[0] == 0
    s = sink.JsonlMetricsSink(str(tmp_path / 'rb.jsonl'))
    for r in records:
        if r['kind'] == 'step':
            s.step_record(r['step'], r['metrics'],
                          host_step_ms=r.get('host_step_ms'))
    s.event_record('selfheal_rollback', from_step=2, to_step=0, label=0)
    s.close()
    for main in (gate.main, jgate.main):
        rc, out = _run(main, [str(tmp_path / 'rb.jsonl'), '--baseline',
                              base, '--no-anomaly', '--allow-missing'])
        assert rc == 1 and 'BREACH selfheal_rollbacks' in out
