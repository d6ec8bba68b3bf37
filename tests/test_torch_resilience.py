"""The port's resilience core against the JAX package on the same inputs:
the data-stream state, the fault grammar, the checkpoint policy, the
preemption handler, the resumed data streams and the resume walk's choice.
"""

import argparse
import copy
import os
import signal
import warnings

import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu.resilience import cli as jcli
from distributed_kfac_pytorch_tpu.resilience import dataiter as jdataiter
from distributed_kfac_pytorch_tpu.resilience import faults as jfaults
from distributed_kfac_pytorch_tpu.resilience import integrity as jintegrity
from distributed_kfac_pytorch_tpu.resilience import policy as jpolicy
from distributed_kfac_pytorch_tpu.resilience import preemption as jpreempt
from distributed_kfac_pytorch_tpu.training import datasets as jdatasets
from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cli
from distributed_kfac_pytorch_tpu_torch.resilience import cli as tcli
from distributed_kfac_pytorch_tpu_torch.resilience import dataiter, faults, \
    integrity, policy, preemption
from distributed_kfac_pytorch_tpu_torch.training import datasets


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# Data-stream state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('seed,epoch,offset,at', [
    (42, 3, 7, 3), (42, 3, 7, 4), (0, 0, 0, 0), (7, 1, 5, 0)])
def test_data_stream_state_matches_jax(seed, epoch, offset, at):
    st = dataiter.DataStreamState(seed, epoch, offset)
    jst = jdataiter.DataStreamState(seed, epoch, offset)
    assert st.scalars() == jst.scalars()
    sc = {k: torch.tensor(v) for k, v in st.scalars().items()}
    assert dataiter.DataStreamState.from_scalars(sc) == st
    assert dataiter.DataStreamState.from_scalars({}, default_seed=9) == \
        dataiter.DataStreamState(9, 0, 0)
    assert dataiter.resume_offset(st, at) == jdataiter.resume_offset(jst, at)
    assert dataiter.resume_offset(None, at) == 0


# ---------------------------------------------------------------------------
# Fault grammar
# ---------------------------------------------------------------------------

VALID_SPECS = ['preempt@3', 'crash@0', 'nan-batch@2', 'crash-in-save@4',
               'corrupt-factor@1', 'corrupt-ckpt@6', 'diverge@5',
               'resize@2->4', 'slice-loss@3->1', 'hang@9', 'slowrank@2',
               'corrupt-ckpt@6,crash@7', ' preempt@1 , crash-in-save@2 ',
               'crash@-1', '', None]
BAD_SPECS = ['explode@3', 'preempt', 'preempt@x', 'preempt@1,preempt@2',
             'resize@2', 'resize@2->0', 'slice-loss@a->1',
             'preempt@1,resize@2->4', 'crash@1.5']


@pytest.mark.parametrize('spec', VALID_SPECS)
def test_parse_spec_matches_jax(spec):
    plan, jplan = faults.parse_spec(spec), jfaults.parse_spec(spec)
    if jplan is None:
        assert plan is None
    else:
        assert (plan.__dict__ == jplan.__dict__ and plan.any())


@pytest.mark.parametrize('spec', BAD_SPECS)
def test_parse_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as jerr:
        jfaults.parse_spec(spec)
    with pytest.raises(ValueError) as err:
        faults.parse_spec(spec)
    assert str(err.value) == str(jerr.value)


def test_plan_from_env(monkeypatch):
    monkeypatch.setenv('KFAC_CHAOS', 'preempt@4,crash-in-save@6')
    assert faults.plan_from_env() == faults.FaultPlan(preempt_at=4,
                                                      crash_in_save_at=6)
    monkeypatch.delenv('KFAC_CHAOS')
    assert faults.plan_from_env() is None


@pytest.mark.parametrize('spec,kind', [
    ('resize@2->4', 'resize'),
    ('slice-loss@3->1', 'slice-loss'), ('hang@9', 'hang'),
    ('slowrank@2', 'slowrank')])
def test_unported_fault_kinds_raise_by_name(monkeypatch, spec, kind):
    # Every kind is ported; a kind taken out of PORTED still raises by
    # name before any step.
    field = kind.replace('-', '_') + '_at'
    assert field in faults.PORTED
    monkeypatch.setattr(faults, 'PORTED',
                        tuple(f for f in faults.PORTED if f != field))
    monkeypatch.setenv('KFAC_CHAOS', spec)
    with pytest.raises(NotImplementedError, match=kind):
        cli.train({'model': 'resnet20'}, device='cpu')


@pytest.mark.parametrize('spec', ['preempt@3', 'crash@1', 'crash-in-save@2',
                                  'corrupt-ckpt@6,crash@7', 'nan-batch@2',
                                  'corrupt-factor@1', 'diverge@5'])
def test_ported_fault_kinds_pass(spec):
    faults.check_ported(faults.parse_spec(spec))


# ---------------------------------------------------------------------------
# Checkpoint policy
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize('every_steps', [0, 1, 3])
@pytest.mark.parametrize('every_secs', [0.0, 2.5])
@pytest.mark.parametrize('start_step', [0, 5])
def test_should_save_matches_jax(every_steps, every_secs, start_step):
    clock, jclock = FakeClock(), FakeClock()
    pol = policy.CheckpointPolicy(every_steps, every_secs,
                                  start_step=start_step, clock=clock)
    jpol = jpolicy.CheckpointPolicy(every_steps, every_secs,
                                    start_step=start_step, clock=jclock)
    seen = []
    for step in range(start_step + 1, start_step + 13):
        clock.t += 1.0 if step % 2 else 0.75
        jclock.t = clock.t
        due = pol.should_save(step)
        assert due == jpol.should_save(step), step
        if due:
            pol.note_saved(step)
            jpol.note_saved(step)
        seen.append(due)
    assert any(seen) == bool(every_steps or every_secs)


def test_policy_rejects_negative_intervals():
    with pytest.raises(ValueError, match='>= 0'):
        policy.CheckpointPolicy(-1)


# ---------------------------------------------------------------------------
# Preemption handler
# ---------------------------------------------------------------------------

def test_sigterm_sets_the_flag_only():
    handler = preemption.PreemptionHandler(grace_secs=5.0,
                                           signals=(signal.SIGUSR1,))
    handler.install()
    try:
        assert not handler.triggered()
        assert handler.remaining_grace() == float('inf')
        os.kill(os.getpid(), signal.SIGUSR1)
        assert handler.triggered()
        assert handler.reason == 'signal SIGUSR1'
        assert 0 < handler.remaining_grace() <= 5.0
    finally:
        handler.uninstall()


def test_second_signal_escalates(monkeypatch):
    killed = []
    monkeypatch.setattr(preemption.os, 'kill',
                        lambda pid, sig: killed.append(sig))
    handler = preemption.PreemptionHandler(signals=(signal.SIGUSR1,))
    handler.install()
    try:
        handler._on_signal(signal.SIGUSR1, None)
        handler._on_signal(signal.SIGUSR1, None)
        assert killed == [signal.SIGUSR1]
        assert signal.getsignal(signal.SIGUSR1) == signal.SIG_DFL
    finally:
        handler.uninstall()


def test_file_source(tmp_path):
    path = tmp_path / 'preempt'
    handler = preemption.PreemptionHandler()
    handler.add_source(preemption.file_source(str(path)))
    assert not handler.triggered()
    path.touch()
    assert handler.triggered()
    assert handler.reason == f'sentinel file {path}'


@pytest.mark.parametrize('raw', [None, '75', '99', '0', '256', 'x'])
def test_relaunch_exit_code_matches_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv('KFAC_RELAUNCH_EXIT', raising=False)
    else:
        monkeypatch.setenv('KFAC_RELAUNCH_EXIT', raw)
    try:
        want = jpreempt._relaunch_exit_code()
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            preemption._relaunch_exit_code()
        return
    assert preemption._relaunch_exit_code() == want


# ---------------------------------------------------------------------------
# Step checkpointer
# ---------------------------------------------------------------------------

class FakeMgr:
    """A duck-typed bundle store (the resume walk's and the
    checkpointer's view of a manager)."""

    def __init__(self, bundles=None, directory='unused'):
        self.bundles = dict(bundles or {})
        self.directory = directory
        self.moved = []

    def save(self, label, tree, force=False, **kw):
        self.bundles[label] = tree

    def all_steps(self):
        return sorted(self.bundles)

    def restore(self, label, **kw):
        if label not in self.bundles:
            raise FileNotFoundError(f'no checkpoint for step {label}')
        return copy.deepcopy(self.bundles[label])

    def quarantine(self, label, reason=None):
        self.moved.append((label, reason))
        self.bundles.pop(label)

    def quarantine_info(self, label):
        return None

    def close(self):
        pass


class Step:
    def __init__(self, step):
        self.step = step


def test_checkpointer_interval_and_preemption():
    mgr = FakeMgr()
    handler = preemption.PreemptionHandler()
    ck = policy.StepCheckpointer(
        mgr, policy.CheckpointPolicy(every_steps=2), lambda st, k: {'k': k},
        preemption=handler, plan=faults.parse_spec('preempt@5'))
    for step in range(1, 5):
        ck.after_step(Step(step), step)
    assert mgr.all_steps() == [2, 4]
    with pytest.raises(preemption.Preempted) as err:
        ck.after_step(Step(5), 5)
    assert err.value.global_step == 5
    assert err.value.reason == 'injected preemption'
    assert mgr.all_steps() == [2, 4, 5]
    assert [s for s, _ in ck.saves] == [2, 4, 5]


def test_poll_drains_only_when_triggered():
    mgr = FakeMgr()
    handler = preemption.PreemptionHandler()
    ck = policy.StepCheckpointer(mgr, None, lambda st, k: {'k': k},
                                 preemption=handler)
    ck.poll(Step(8), 0)
    assert mgr.all_steps() == []
    handler.trigger('test')
    with pytest.raises(preemption.Preempted,
                       match='test at global step 8') as err:
        ck.poll(Step(8), 0)
    assert mgr.bundles[8] == {'k': 0}
    # Drained between epochs: no step of the epoch to report.
    assert err.value.partial == {'losses': [], 'fired': [], 'step_ms': []}


# ---------------------------------------------------------------------------
# Resumed data streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('skip', [0, 1, 3, 4])
@pytest.mark.parametrize('augment', [True, False])
def test_epoch_batches_skip_matches_jax(skip, augment):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 32, 32, 3)).astype(np.float32)   # NHWC
    y = np.arange(40, dtype=np.int64)
    want = list(jdatasets.epoch_batches(x, y, 10, seed=5, epoch=2,
                                        augment=augment, skip_batches=skip))
    got = list(datasets.epoch_batches(
        np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y, 10, seed=5,
        epoch=2, augment=augment, skip_batches=skip))
    full = list(datasets.epoch_batches(
        np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y, 10, seed=5,
        epoch=2, augment=augment))
    assert len(got) == len(want) == 4 - skip
    for (xa, ya), (xb, yb), (xc, yc) in zip(got, want, full[skip:]):
        np.testing.assert_array_equal(xa, xb.transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(xa, xc)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(ya, yc)


def test_consume_augment_rng_matches_augment():
    x = np.zeros((8, 3, 32, 32), np.float32)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    datasets.augment_cifar(x, r1)
    datasets.consume_augment_rng(r2, 8)
    assert r1.integers(0, 1 << 30) == r2.integers(0, 1 << 30)


@pytest.mark.parametrize('skip', [0, 3])
def test_bptt_batches_skip_matches_jax(skip):
    ids = np.arange(1000, dtype=np.int32)
    kw = dict(shuffle_offset=True, seed=1, epoch=3, skip_batches=skip)
    got = list(datasets.bptt_batches(ids, 4, 10, **kw))
    want = list(jdatasets.bptt_batches(ids, 4, 10, **kw))
    assert len(got) == len(want)
    for (xa, ta), (xb, tb) in zip(got, want):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ta, tb)


# ---------------------------------------------------------------------------
# The resume walk's choice, against the JAX walk on the same fakes
# ---------------------------------------------------------------------------

def _bundle(pkg, step, epoch, offset, seed=0, corrupt=False):
    """A stamped bundle of the package ``pkg`` ('jax' or 'torch')."""
    leaf = (np.full(2, float(step), np.float32) if pkg == 'jax'
            else torch.full((2,), float(step)))
    tree = {'params': {'w': leaf}, 'opt_state': {}, 'kfac': {},
            'extra_vars': {},
            'scalars': {'step': step, 'epoch': epoch,
                        'step_in_epoch': offset, 'data_seed': seed}}
    (jintegrity if pkg == 'jax' else integrity).stamp(tree)
    if corrupt:
        tree['params']['w'] = tree['params']['w'] + 1
    return tree


# (step bundles, epoch bundles) as {label: (step, epoch, offset[, corrupt])}
RESUME_CASES = {
    'step_newer_wins': ({27: (27, 2, 7)}, {1: (20, 2, 0)}),
    'stale_step_loses': ({13: (13, 1, 3)}, {4: (50, 5, 0)}),
    'epoch_end_ties_to_epoch': ({8: (8, 0, 8)}, {0: (8, 1, 0)}),
    'corrupt_newest_step': ({8: (8, 0, 8, True), 4: (4, 0, 4)}, {}),
    'corrupt_epoch_falls_back': ({}, {1: (16, 2, 0, True),
                                      0: (8, 1, 0)}),
    'corrupt_step_then_epoch': ({6: (6, 0, 6, True), 3: (3, 0, 3)},
                                {0: (4, 1, 0)}),
    'nothing': ({}, {}),
    'all_corrupt': ({5: (5, 0, 5, True)}, {0: (8, 1, 0, True)}),
}


def _managers(pkg, case):
    steps, epochs = RESUME_CASES[case]
    mk = {k: _bundle(pkg, *v) for k, v in steps.items()}
    ek = {k: _bundle(pkg, *v) for k, v in epochs.items()}
    return FakeMgr(ek), FakeMgr(mk)


def _args(**kw):
    return argparse.Namespace(**{'no_resume': False, 'resume_step': None,
                                 'checkpoint_dir': 'ck', 'seed': 0, **kw})


def _outcome(run):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        try:
            res = run()
        except SystemExit as e:
            return 'exit', str(e).split(':')[0], len(caught)
    if res is None:
        return None, len(caught)
    tree, start_epoch, offset, source = res
    return (source, int(tree['scalars']['step']), start_epoch, offset,
            len(caught))


@pytest.mark.parametrize('case', sorted(RESUME_CASES))
@pytest.mark.parametrize('resume_step', [None, 3, 8, 27])
def test_resume_choice_matches_jax(case, resume_step):
    jem, jsm = _managers('jax', case)
    tem, tsm = _managers('torch', case)
    jargs, targs = _args(resume_step=resume_step), _args(
        resume_step=resume_step)
    want = _outcome(lambda: jcli.resume(jargs, jem, jsm, {}))
    got = _outcome(lambda: tcli.resume(targs, tem, tsm))
    assert got == want
    assert [m for m, _ in tsm.moved] == [m for m, _ in jsm.moved]
    assert [m for m, _ in tem.moved] == [m for m, _ in jem.moved]


@pytest.mark.parametrize('no_resume', [False, True])
def test_resume_adopts_data_seed_and_no_resume(no_resume):
    jem, jsm = FakeMgr(), FakeMgr({5: _bundle('jax', 5, 0, 5, seed=7)})
    tem, tsm = FakeMgr(), FakeMgr({5: _bundle('torch', 5, 0, 5, seed=7)})
    jargs = _args(seed=42, no_resume=no_resume)
    targs = _args(seed=42, no_resume=no_resume)
    jres = jcli.resume(jargs, jem, jsm, {})
    tres = tcli.resume(targs, tem, tsm)
    assert (jres is None) == (tres is None) == no_resume
    assert targs.seed == jargs.seed == (42 if no_resume else 7)


# ---------------------------------------------------------------------------
# Two gloo ranks on the CPU: DistributedKFAC preempted and resumed
# ---------------------------------------------------------------------------

WORLD_ARGV = ['--model', 'resnet20', '--batch-size', '8',
              '--val-batch-size', '6', '--synthetic-size', '24',
              '--epochs', '2', '--device', 'cpu', '--kfac-update-freq', '4',
              '--comm-method', 'mem-opt', '--inv-pipeline-chunks', '2',
              '--deferred-factor-reduction', '--checkpoint-freq', '1',
              '--checkpoint-steps', '2', '--quiet']


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _world(directory, chaos=None, n=2):
    """``n`` ranks of the CIFAR CLI (module entry point) in a gloo group
    on the CPU; returns their exit codes and outputs."""
    import subprocess
    import sys
    from pathlib import Path
    port = _free_port()
    procs = []
    for rank in range(n):
        env = {**os.environ, 'RANK': str(rank), 'WORLD_SIZE': str(n),
               'LOCAL_RANK': '0', 'MASTER_ADDR': 'localhost',
               'MASTER_PORT': str(port), 'OMP_NUM_THREADS': '1'}
        env.pop('KFAC_CHAOS', None)
        if chaos:
            env['KFAC_CHAOS'] = chaos
        procs.append(subprocess.Popen(
            [sys.executable, '-m',
             'distributed_kfac_pytorch_tpu_torch.train_cifar10_resnet',
             *WORLD_ARGV, '--checkpoint-dir', str(directory)],
            cwd=Path(__file__).resolve().parent.parent, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def test_two_gloo_ranks_preempt_and_resume_file_by_file(tmp_path):
    from distributed_kfac_pytorch_tpu_torch.training.checkpoint import \
        RANK_FILE
    rcs, outs = _world(tmp_path / 'ref')
    assert rcs == [0, 0], outs[0][-3000:]
    # Rank 0's verdict drains both ranks at step 3, mid-window.
    rcs, outs = _world(tmp_path / 'run', 'preempt@3')
    assert rcs == [preemption.RELAUNCH_EXIT_CODE] * 2, outs[0][-3000:]
    files = sorted(os.listdir(tmp_path / 'run' / 'steps' / '3'))
    assert files == ['bundle.pt', RANK_FILE.format(0), RANK_FILE.format(1)]
    rcs, outs = _world(tmp_path / 'run')
    assert rcs == [0, 0], outs[0][-3000:]
    for name in files:
        ref = torch.load(tmp_path / 'ref' / '1' / name, weights_only=True)
        got = torch.load(tmp_path / 'run' / '1' / name, weights_only=True)
        _assert_same(got, ref, name)
    rank0 = torch.load(tmp_path / 'ref' / '1' / RANK_FILE.format(0),
                       weights_only=True)
    assert rank0['kfac']['inv_layout']['n_rows'] == 2
    assert {'factor_accum', 'accum_decay', 'inv_stacks'} <= set(
        rank0['kfac'])


def _assert_same(a, b, path):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f'{path}[{k!r}]')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f'{path}[{i}]')
    else:
        assert a == b, (path, a, b)
