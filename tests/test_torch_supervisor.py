"""Supervision of the torch port against the JAX package, on the CPU:
heartbeat leases written by one package and read by the other, lease age
and incarnation filtering, the emitter's stride, the restart backoff (same
seed, same schedule), the crash-loop detector, the capacity file and the
persistent-straggler classifier, each decision equal to JAX's on the same
inputs; the ``Supervisor`` matrix of ``tests/test_supervisor.py`` with tiny
rank children (which import the port's ``heartbeat.py`` by file path, not
through the package ``__init__``, which imports torch), where a child is a
world of ``--devices`` rank processes; the gate and report reading the
supervisor's sidecar; and the heartbeat flags through the three CLIs, a
run with them on equal to the run with them off, bit for bit.
"""

import json
import os
import pathlib
import random
import sys

import pytest
import torch

from distributed_kfac_pytorch_tpu.resilience import heartbeat as jhb
from distributed_kfac_pytorch_tpu.resilience import supervisor as jsup
from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cli
from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet as inet
from distributed_kfac_pytorch_tpu_torch import train_language_model as lm
from distributed_kfac_pytorch_tpu_torch.observability import gate, report
from distributed_kfac_pytorch_tpu_torch.observability import sink as obs_sink
from distributed_kfac_pytorch_tpu_torch.resilience import faults
from distributed_kfac_pytorch_tpu_torch.resilience import heartbeat as hb
from distributed_kfac_pytorch_tpu_torch.resilience import supervisor as sup
from test_supervisor import _shards

REPO = pathlib.Path(__file__).resolve().parents[1]
RESIL = REPO / 'distributed_kfac_pytorch_tpu_torch' / 'resilience'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# Leases, backoff, crash loop, capacity, stragglers: decisions as JAX's
# ---------------------------------------------------------------------------

def test_leases_cross_read_and_age(tmp_path):
    a = hb.write_lease(str(tmp_path / 'rank0.lease'), rank=0, step=17,
                       incarnation=3, clock=lambda: 123.5)
    b = jhb.write_lease(str(tmp_path / 'rank1.lease'), rank=1, step=4,
                        incarnation=2, clock=lambda: 100.0)
    assert jhb.read_lease(str(tmp_path / 'rank0.lease')) == a
    assert hb.read_lease(str(tmp_path / 'rank1.lease')) == b
    for now in (95.0, 100.0, 130.0):
        assert hb.lease_age(b, now) == jhb.lease_age(b, now)
    (tmp_path / 'rank2.lease').write_text('garbage')
    (tmp_path / 'rank3.lease').write_text(json.dumps(
        {'wall_time': 1.0, 'incarnation': 'x'}))
    for inc in (None, 2, 3):
        got, want = hb.scan_leases(str(tmp_path), incarnation=inc), \
            jhb.scan_leases(str(tmp_path), incarnation=inc)
        assert got[0] == want[0] and set(got[1]) == set(want[1])
    for mod, path in ((hb, 'nope'), (jhb, 'nope')):
        assert mod.read_lease(str(tmp_path / path)) is None
        assert mod.scan_leases(str(tmp_path / 'gone')) == ({}, {})
    with pytest.raises(ValueError, match='undecodable'):
        hb.read_lease(str(tmp_path / 'rank2.lease'))
    hb.clear_leases(str(tmp_path))
    assert hb.scan_leases(str(tmp_path)) == ({}, {})


def test_emitter_stride_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(hb.ENV_INCARNATION, '4')
    out = []
    for mod, d in ((hb, tmp_path / 'port'), (jhb, tmp_path / 'jax')):
        em = mod.HeartbeatEmitter(str(d), 1, every=3)
        writes = []
        for step in range(1, 8):
            em.beat(step)
            writes.append(mod.read_lease(em.path)['step'])
        em.close()
        lease = mod.read_lease(em.path)
        out.append((writes, lease['step'], lease['incarnation'],
                    lease['rank']))
    assert out[0] == out[1] == ([1, 1, 3, 3, 3, 6, 6], 7, 4, 1)
    with pytest.raises(ValueError):
        hb.HeartbeatEmitter(str(tmp_path), 0, every=0)


@pytest.mark.parametrize('kw', [
    dict(base=1.0, factor=2.0, cap=8.0, jitter=0.0),
    dict(base=1.0, factor=2.0, cap=8.0, jitter=0.5, seed=123),
    dict(base=0.5, factor=3.0, cap=60.0, jitter=0.25, seed=7)], ids=str)
def test_backoff_schedule_as_jax(kw):
    a, b = sup.RestartBackoff(**kw), jsup.RestartBackoff(**kw)
    assert [a.next_delay() for _ in range(7)] == \
        [b.next_delay() for _ in range(7)]
    a.reset(), b.reset()
    assert [a.next_delay() for _ in range(3)] == \
        [b.next_delay() for _ in range(3)]
    for bad in (dict(factor=0.5), dict(jitter=1.5), dict(base=-1.0)):
        with pytest.raises(ValueError):
            sup.RestartBackoff(**bad)


def test_crash_loop_and_capacity_as_jax(tmp_path):
    rng = random.Random(0)
    for after in (1, 2, 3):
        a, b = sup.CrashLoopDetector(after), jsup.CrashLoopDetector(after)
        for _ in range(40):
            step = rng.choice([None, 3, 3, 7, 9])
            assert a.observe(step) == b.observe(step)
            assert (a.count, a.step) == (b.count, b.step)
    with pytest.raises(ValueError):
        sup.CrashLoopDetector(0)
    path = tmp_path / 'cap'
    a, b = sup.CapacityFile(str(path)), jsup.CapacityFile(str(path))
    for text in (None, '3\n', '', '4 devices', '', '2', '', '5'):
        if text is not None:
            path.write_text(text)
        assert a.read() == b.read()


@pytest.mark.parametrize('case', [
    dict(slow_rank=2), dict(jitter_rank=1), dict(slow_rank=0, skew_ms=5.0),
    dict(slow_rank=0, n=4), dict(slow_rank=1, n=400, frozen=True), {}],
    ids=str)
def test_classify_stragglers_as_jax(case):
    case = dict(case)
    frozen = case.pop('frozen', False)
    shards = _shards(**case)
    if frozen:
        shards[3] = [{'kind': 'step', 'step': s, 'host_step_ms': 10.0}
                     for s in range(20)]
    for skew, steps in ((20.0, 8), (50.0, 8), (20.0, 4)):
        assert sup.classify_stragglers(shards, skew_ms=skew,
                                       min_steps=steps) == \
            jsup.classify_stragglers(shards, skew_ms=skew, min_steps=steps)
    assert sup.classify_stragglers({}, skew_ms=20.0) is None


def test_exit_codes_and_event_kinds():
    assert (sup.EXHAUSTED_EXIT, sup.CRASH_LOOP_EXIT) == \
        (jsup.EXHAUSTED_EXIT, jsup.CRASH_LOOP_EXIT) == (76, 77)
    for kind in ('supervisor_restart', 'supervisor_failover',
                 'supervisor_growback', 'hang_detected', 'crash_loop',
                 'capacity_degraded', 'topology_change'):
        assert kind in obs_sink.EVENT_KINDS


# ---------------------------------------------------------------------------
# The Supervisor matrix, with tiny rank children
# ---------------------------------------------------------------------------

_CHILD_PRELUDE = """\
import os, sys, time
# The port's stdlib-only modules, imported by file path: the package
# __init__ imports torch, which would dominate each tiny child.
sys.path.insert(0, {resil!r})
import heartbeat as hb
from preemption import RELAUNCH_EXIT_CODE
inc = int(os.environ[hb.ENV_INCARNATION])
d = os.environ[hb.ENV_DIR]
sentinel = os.environ['KFAC_PREEMPT_FILE']
me = int(os.environ.get('RANK', '0'))
world = os.environ.get('WORLD_SIZE', '-')
def beat(step, rank=None):
    rank = me if rank is None else rank
    hb.write_lease(hb.lease_path(d, rank), rank=rank, step=step,
                   incarnation=inc)
"""


def _supervise(tmp_path, child_body, **kw):
    """Run a ``Supervisor`` over a tiny child (``devices=N``: a world of
    N of them); returns ``(rc, events, sup)``."""
    script = _CHILD_PRELUDE.format(resil=str(RESIL)) + child_body
    defaults = dict(
        workdir=str(tmp_path / 'sup'),
        hang_timeout=1.0, startup_grace=10.0, poll_secs=0.05,
        drain_grace=5.0, term_grace=1.0, max_restarts=5,
        backoff=sup.RestartBackoff(base=0.0, cap=0.0))
    defaults.update(kw)
    s = sup.Supervisor([sys.executable, '-c', script], **defaults)
    rc = s.run(install_signals=False)
    events = [(r['event'], r.get('data', {}))
              for r in obs_sink.read_jsonl(s.events_path)
              if r['kind'] == 'event']
    return rc, events, s


def test_crash_relaunch_until_success(tmp_path):
    rc, events, s = _supervise(tmp_path, """\
beat(5 + inc)
sys.exit(1 if inc < 2 else 0)
""")
    assert rc == 0
    assert [k for k, _ in events] == ['supervisor_restart'] * 2
    assert all(d['reason'] == 'crash' and d['rc'] == 1 for _, d in events)
    assert [d['last_step'] for _, d in events] == [5, 6]
    assert s.restarts == 2 and s.launches == 3


def test_one_rank_crashing_kills_its_world(tmp_path):
    """A rank exiting nonzero is a crash: the other ranks (blocked as on a
    collective) are killed and the world relaunches."""
    rc, events, s = _supervise(tmp_path, """\
beat(2 + inc)
if inc == 0:
    if me == 1:
        sys.exit(3)
    time.sleep(60)
sys.exit(0)
""", devices=3)
    assert rc == 0
    assert [(k, d['rc']) for k, d in events] == [('supervisor_restart', 3)]
    assert s.history[0]['rc'] == 3 and s.history[0]['world'] == 3


def test_budget_exhaustion_exit_code(tmp_path):
    rc, events, s = _supervise(tmp_path, """\
beat(inc)  # progressing: the crash-loop detector never trips
sys.exit(1)
""", max_restarts=2, crash_loop_after=10)
    assert rc == sup.EXHAUSTED_EXIT == 76
    assert s.launches == 3
    assert [k for k, _ in events] == ['supervisor_restart'] * 2


def test_crash_loop_distinct_exit_and_diagnostic(tmp_path):
    rc, events, s = _supervise(tmp_path, """\
beat(7)  # the same step fails every launch
sys.exit(1)
""", crash_loop_after=2, max_restarts=10)
    assert rc == sup.CRASH_LOOP_EXIT == 77
    assert [k for k, _ in events] == ['supervisor_restart', 'crash_loop']
    loop = dict(events[-1][1])
    assert loop['failure_step'] == 7 and loop['consecutive'] == 2
    diag = json.load(open(loop['diagnostic']))
    assert diag['failure_step'] == 7 and diag['history']
    assert diag['leases']['0']['step'] == 7


def test_crash_loop_counter_resets_on_progress(tmp_path):
    rc, events, _s = _supervise(tmp_path, """\
beat(inc)
sys.exit(1)
""", crash_loop_after=2, max_restarts=3)
    assert rc == sup.EXHAUSTED_EXIT
    assert 'crash_loop' not in [k for k, _ in events]


def test_hang_detected_kill_and_relaunch(tmp_path):
    rc, events, _s = _supervise(tmp_path, """\
if inc == 0:
    beat(3)
    time.sleep(60)  # stop beating without exiting
sys.exit(0)
""", hang_timeout=0.5, devices=2)
    assert rc == 0
    assert [k for k, _ in events] == ['hang_detected', 'supervisor_restart']
    hang = dict(events[0][1])
    assert hang['last_step'] == 3 and hang['newest_age_s'] >= 0.5
    assert hang['ranks'] == [0, 1]
    assert dict(events[1][1])['reason'] == 'hang'


def test_cooperative_drain_is_not_budgeted(tmp_path):
    rc, events, s = _supervise(tmp_path, """\
beat(2)
sys.exit(RELAUNCH_EXIT_CODE if inc == 0 else 0)
""", max_restarts=0, devices=2)
    assert rc == 0
    assert [k for k, _ in events] == ['supervisor_restart']
    assert events[0][1]['reason'] == 'drain' and s.restarts == 0


_COOPERATIVE_LOOP = """\
open(os.path.join(d, 'world%d.%d.txt' % (inc, me)), 'w').write(world)
if inc == 0:
    for i in range(600):
        beat(i)
        if os.path.exists(sentinel):
            sys.exit(RELAUNCH_EXIT_CODE)
        time.sleep(0.02)
    sys.exit(1)
sys.exit(0)
"""


def _worlds(s, inc):
    files = sorted(pathlib.Path(s.heartbeat_dir).glob(f'world{inc}.*.txt'))
    return [f.read_text() for f in files]


def test_capacity_failover_shrinks_world(tmp_path):
    cap = tmp_path / 'capacity'
    cap.write_text('2')
    rc, events, s = _supervise(tmp_path, _COOPERATIVE_LOOP, devices=4,
                               capacity_file=str(cap))
    assert rc == 0
    assert [k for k, _ in events] == ['supervisor_failover']
    data = dict(events[0][1])
    assert data['reason'] == 'capacity'
    assert (data['from_devices'], data['to_devices']) == (4, 2)
    assert _worlds(s, 0) == ['4'] * 4 and _worlds(s, 1) == ['2'] * 2


def test_capacity_growback(tmp_path):
    cap = tmp_path / 'capacity'
    cap.write_text('4')
    rc, events, s = _supervise(tmp_path, _COOPERATIVE_LOOP, devices=4,
                               start_devices=2, capacity_file=str(cap))
    assert rc == 0
    assert [k for k, _ in events] == ['supervisor_growback']
    data = dict(events[0][1])
    assert (data['from_devices'], data['to_devices']) == (2, 4)
    assert _worlds(s, 0) == ['2'] * 2 and _worlds(s, 1) == ['4'] * 4


def test_dead_rank_failover_to_survivor_world(tmp_path):
    rc, events, s = _supervise(tmp_path, """\
if inc == 0:
    if me == 1:
        beat(0)          # rank 1 beats once, then goes silent
        time.sleep(60)
    for i in range(600):
        beat(i)          # rank 0 stays alive (wedged on collectives)
        time.sleep(0.02)
    sys.exit(1)
sys.exit(0)
""", devices=2, failover_grace=0.5, hang_timeout=30.0)
    assert rc == 0
    assert [k for k, _ in events] == ['supervisor_failover']
    data = dict(events[0][1])
    assert data['reason'] == 'dead_rank'
    assert data['dead_ranks'] == '1' and data['live_ranks'] == '0'
    assert (data['from_devices'], data['to_devices']) == (2, 1)
    assert s.world == 1


def test_dead_rank_without_shrinkable_world_is_budgeted(tmp_path):
    rc, events, s = _supervise(tmp_path, """\
beat(0, rank=1)          # a rank that wedges every incarnation
for i in range(600):
    beat(i, rank=0)
    time.sleep(0.02)
sys.exit(1)
""", failover_grace=0.4, hang_timeout=30.0, max_restarts=1)
    assert rc == sup.EXHAUSTED_EXIT
    assert [k for k, _ in events] == ['supervisor_restart']
    assert events[0][1]['reason'] == 'dead_rank' and s.restarts == 2


def test_faults_cleared_on_relaunch_unless_kept(tmp_path, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, 'crash@1')
    body = """\
beat(1)
sys.exit(1 if os.environ.get('KFAC_CHAOS') else 0)
"""
    rc, _events, _s = _supervise(tmp_path / 'a', body)
    assert rc == 0
    rc, _events, s = _supervise(tmp_path / 'b', body, keep_faults=True,
                                max_restarts=1, crash_loop_after=5)
    assert rc == sup.EXHAUSTED_EXIT and s.launches == 2


def test_validation_and_namespacing(tmp_path):
    with pytest.raises(ValueError, match='no command'):
        sup.Supervisor([], workdir=str(tmp_path))
    with pytest.raises(ValueError, match='hang-timeout'):
        sup.Supervisor(['x'], workdir=str(tmp_path), hang_timeout=0)
    a = sup.Supervisor(['x'], workdir=str(tmp_path / 'w'), instance='jobA')
    b = sup.Supervisor(['x'], workdir=str(tmp_path / 'w'))
    try:
        assert a.heartbeat_dir.endswith(os.path.join('heartbeats', 'jobA'))
        assert a.events_path.endswith('supervisor.jobA.jsonl')
        assert a.sentinel.endswith('drain.jobA.sentinel')
        assert b.heartbeat_dir != a.heartbeat_dir
    finally:
        a.events.close(), b.events.close()
    metrics = str(tmp_path / 'run.jsonl')
    c = sup.Supervisor(['x'], workdir=str(tmp_path / 'w'),
                       metrics_path=metrics)
    c.events.close()
    assert c.events_path == metrics + obs_sink.SUPERVISOR_SIDECAR_SUFFIX


def test_gate_and_report_read_the_sidecar(tmp_path, capsys):
    run = tmp_path / 'run.jsonl'
    s = obs_sink.JsonlMetricsSink(str(run))
    for i in range(4):
        s.step_record(i, {'loss': 1.0}, host_step_ms=10.0)
    s.close()
    base = tmp_path / 'base.json'
    assert gate.main([str(run), '--write-baseline', str(base)]) == 0
    rc, events, _s = _supervise(tmp_path, """\
beat(1 + inc)
sys.exit(1 if inc < 2 else 0)
""", metrics_path=str(run))
    assert rc == 0 and [k for k, _ in events] == ['supervisor_restart'] * 2
    capsys.readouterr()
    assert gate.main([str(run), '--baseline', str(base), '--json',
                      '--no-anomaly']) == 1
    verdict = json.loads(capsys.readouterr().out)
    assert verdict['current']['supervisor_restarts'] == 2
    assert report.main([str(run), '--json']) == 0
    assert json.loads(capsys.readouterr().out)['supervision'][
        'restarts'] == 2


def test_main_runs_a_world(tmp_path):
    script = _CHILD_PRELUDE.format(resil=str(RESIL)) + \
        "beat(1)\nsys.exit(0 if world == '2' else 1)\n"
    rc = sup.main(['--workdir', str(tmp_path), '--devices', '2',
                   '--poll', '0.05', '--', sys.executable, '-c', script])
    assert rc == 0


# ---------------------------------------------------------------------------
# The heartbeat flags through the three CLIs
# ---------------------------------------------------------------------------

INET_SMALL = {'model': 'resnet18', 'image_size': 32, 'batch_size': 4,
              'val_batch_size': 2, 'synthetic_size': 8, 'epochs': 1,
              'inverse_method': 'cholesky', 'kfac_update_freq': 1,
              'kfac_cov_update_freq': 1, 'quiet': True,
              'skip_layers': ['layer3_block0', 'layer3_block1',
                              'layer4_block0', 'layer4_block1']}
SMALL = {
    'cifar': (cli, {'model': 'resnet20', 'batch_size': 8,
                    'val_batch_size': 4, 'synthetic_size': 32, 'epochs': 1,
                    'no_augment': True, 'quiet': True}),
    'imagenet': (inet, INET_SMALL),
    'lm': (lm, {'arch': 'transformer', 'emsize': 16, 'nhid': 16,
                'nlayers': 1, 'nheads': 2, 'bptt': 8, 'batch_size': 4,
                'epochs': 1, 'max_steps': 4, 'kfac_update_freq': 2,
                'warmup_epochs': 0, 'quiet': True}),
}


@pytest.mark.parametrize('flag', ['heartbeat_dir', 'heartbeat_every'])
@pytest.mark.parametrize('name', list(SMALL))
def test_heartbeat_flag_runs_with_its_effect(tmp_path, monkeypatch, name,
                                             flag):
    module, config = SMALL[name]
    d = tmp_path / 'hb'
    written = []
    write = hb.write_lease

    def spy(path, **kw):
        written.append(kw['step'])
        return write(path, **kw)

    monkeypatch.setattr(hb, 'write_lease', spy)
    if flag == 'heartbeat_dir':
        over = {'heartbeat_dir': str(d)}
    else:
        monkeypatch.setenv(hb.ENV_DIR, str(d))
        over = {'heartbeat_every': 2}
    res = module.train({**config, **over}, device='cpu')
    steps = res['steps']
    lease = hb.read_lease(str(d / 'rank0.lease'))
    assert lease['step'] == steps and lease['rank'] == 0
    every = over.get('heartbeat_every', 1)
    beats = [1] + [s for s in range(2, steps + 1) if s % every == 0]
    assert written == beats + [steps]


def test_heartbeats_on_equal_off_bit_for_bit(tmp_path):
    """Leases are host file I/O: the run with them equals the run
    without, loss by loss and parameter by parameter."""
    module, config = SMALL['cifar']
    off = module.train(dict(config), device='cpu')
    on = module.train({**config, 'heartbeat_dir': str(tmp_path)},
                      device='cpu')
    assert on['losses'] == off['losses']
    for a, b in zip(on['state'].model.state_dict().values(),
                    off['state'].model.state_dict().values()):
        assert torch.equal(a, b)
