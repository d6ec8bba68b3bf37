"""The port's checkpoint bundles (``training/checkpoint.py``,
``resilience/integrity.py``): the manager's round trip, retention,
replacement, torn writes, quarantine and bit-rot detection; and, through
the CIFAR CLI, unclean kills (``crash@K``, ``crash-in-save@K``), a
corrupted bundle (``corrupt-ckpt@K``), ``--no-resume``, ``--resume-step``,
the ``-sgd`` directory suffix and the adoption of the bundle's data seed.
"""

import collections
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cli
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
from distributed_kfac_pytorch_tpu_torch.resilience import faults, integrity
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import \
    RELAUNCH_EXIT_CODE
from distributed_kfac_pytorch_tpu_torch.training.checkpoint import (
    BUNDLE_FILE,
    CheckpointManager,
    bundle_state,
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_same(a, b, path='bundle'):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f'{path}[{k!r}]')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{path}[{i}]')
    else:
        assert a == b, (path, a, b)


def _tree(step=3, **over):
    gen = torch.Generator().manual_seed(step)
    model_sd = collections.OrderedDict(
        [('conv.weight', torch.randn(4, 3, 3, 3, generator=gen)),
         ('bn.running_var', torch.rand(4, generator=gen)),
         ('bn.num_batches_tracked', torch.tensor(step))])
    opt = {'state': {0: {'momentum_buffer': torch.randn(4, 3, 3, 3,
                                                        generator=gen)}},
           'param_groups': [{'lr': 0.1, 'momentum': 0.9, 'nesterov': False,
                             'foreach': None, 'params': [0]}]}
    kfac = {'step': step, 'factors': {'fc': {
        'A': torch.eye(3, dtype=torch.bfloat16), 'G': torch.eye(2)}},
        'accum_decay': torch.tensor(0.9), 'inv_chunk_phase': 1}
    extra = {'dropout_generator': torch.Generator().get_state()}
    return bundle_state(model_sd, opt, kfac, extra, step=step, epoch=0,
                        step_in_epoch=step, data_seed=42, **over)


# ---------------------------------------------------------------------------
# Integrity
# ---------------------------------------------------------------------------

def test_checksum_is_deterministic_and_sees_one_byte():
    a, b = _tree(), _tree()
    assert integrity.tree_checksum(a) == integrity.tree_checksum(b) != 0
    assert a['scalars'][integrity.CHECKSUM_KEY] == integrity.tree_checksum(a)
    assert integrity.verify_tree(a) == (True, integrity.tree_checksum(a),
                                        integrity.tree_checksum(a))
    w = b['params']['conv.weight']
    w.view(torch.int32).reshape(-1)[5] ^= 1       # one bit of one float
    ok, recorded, actual = integrity.verify_tree(b)
    assert ok is False and recorded != actual
    assert 'content digest mismatch' in integrity.describe_mismatch(
        recorded, actual)
    c = _tree()
    c['scalars']['data_seed'] = 43                # a scalar counts too
    assert integrity.verify_tree(c)[0] is False


@pytest.mark.parametrize('mode,want', [(True, True), ('template', None),
                                       (False, None)])
def test_bundle_state_integrity_modes(mode, want):
    tree = _tree(integrity=mode)
    assert set(tree) == {'params', 'opt_state', 'kfac', 'extra_vars',
                         'scalars'}
    assert integrity.verify_tree(tree)[0] is want
    assert (integrity.CHECKSUM_KEY in tree['scalars']) == bool(mode)
    stripped = integrity.strip_checksum(tree)
    assert integrity.CHECKSUM_KEY not in stripped['scalars']
    assert integrity.recorded_checksum(stripped) is None


def test_checksum_rejects_unknown_leaves():
    with pytest.raises(TypeError, match='not a tensor'):
        integrity.tree_checksum({'x': object()})


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------

def test_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(3, tree)
    assert os.listdir(tmp_path / '3') == [BUNDLE_FILE]
    got = mgr.restore(3)
    assert_same(got, tree)
    assert isinstance(got['params'], collections.OrderedDict)
    assert mgr.latest_epoch() == 3 and mgr.restore()['scalars']['step'] == 3
    with pytest.raises(FileNotFoundError, match=r'steps on disk: \[3\]'):
        mgr.restore(4)
    with pytest.raises(FileNotFoundError, match='no checkpoints found'):
        CheckpointManager(str(tmp_path / 'empty')).restore()


def test_max_to_keep_and_force(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for label in (1, 2, 3):
        mgr.save(label, _tree(label))
    assert mgr.all_steps() == [2, 3]
    with pytest.raises(FileExistsError, match='force=True'):
        mgr.save(3, _tree(7))
    mgr.save(3, _tree(7), force=True)
    assert mgr.restore(3)['scalars']['step'] == 7
    assert sorted(os.listdir(tmp_path)) == ['2', '3']
    keep_all = CheckpointManager(str(tmp_path / 'all'), max_to_keep=None)
    for label in range(4):
        keep_all.save(label, _tree(label))
    assert keep_all.all_steps() == [0, 1, 2, 3]


def test_torn_write_is_never_a_bundle(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _tree(2))
    torn = faults.torn_step_dir(str(tmp_path), 5)
    assert os.path.isdir(torn)
    assert mgr.latest_epoch() == 2 and mgr.all_steps() == [2]
    mgr.save(5, _tree(5))                 # the next save clears the tear
    assert mgr.all_steps() == [2, 5] and not os.path.exists(torn)


def test_crash_in_save_leaves_the_label_uncommitted(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def die():
        raise KeyboardInterrupt('killed between write and rename')

    with pytest.raises(KeyboardInterrupt):
        mgr.save(4, _tree(4), before_commit=die)
    assert mgr.all_steps() == []
    assert os.listdir(tmp_path / '4.partial') == [BUNDLE_FILE]


def test_quarantine_and_its_reason(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(6, _tree(6))
    assert mgr.quarantine_info(6) is None
    moved = mgr.quarantine(6, reason='content digest mismatch')
    assert moved == str(tmp_path / '6.quarantined')
    assert mgr.all_steps() == [] and mgr.latest_epoch() is None
    assert mgr.quarantine_info(6) == (moved, 'content digest mismatch')
    mgr.save(6, _tree(6))
    assert mgr.quarantine_info(6) is None     # a live bundle supersedes
    second = mgr.quarantine(6)
    assert second.endswith('6.quarantined.1')
    assert mgr.quarantined_paths(6) == [moved, second]
    assert mgr.quarantine_info(6) == (second, 'no recorded reason')
    assert mgr.quarantine(6) is None


def test_corrupt_bundle_file_is_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(8, _tree(8))
    victim = faults.corrupt_bundle_file(str(tmp_path), 8)
    assert victim == str(tmp_path / '8' / BUNDLE_FILE)
    # Either the zip reader refuses it or the digest does not match.
    with pytest.raises((integrity.ChecksumMismatch, RuntimeError)):
        mgr.restore(8)
    with pytest.raises(FileNotFoundError):
        faults.corrupt_bundle_file(str(tmp_path), 9)


def test_manager_stamps_each_file_it_writes(tmp_path):
    """A tree that records the field unhashed ('template') is written with
    its digest, and the caller's tree is left as it was."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(2, integrity='template')
    mgr.save(2, tree)
    assert tree['scalars'][integrity.CHECKSUM_KEY] == integrity.UNVERIFIED
    on_disk = torch.load(tmp_path / '2' / BUNDLE_FILE, weights_only=True)
    assert integrity.verify_tree(on_disk)[0] is True
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        got = mgr.restore(2)
    assert got['scalars'][integrity.CHECKSUM_KEY] == \
        integrity.tree_checksum(tree)


def test_unverified_bundle_restores_with_a_warning(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1, integrity=False))
    with pytest.warns(RuntimeWarning, match='UNVERIFIED'):
        mgr.restore(1)


def test_kfac_state_round_trips_with_inverses(tmp_path):
    model = cifar_resnet.get_model('resnet20')
    kfac = KFAC(model, device='cpu', inv_staleness=1, inv_update_freq=4,
                factor_update_freq=1, deferred_factor_reduction=True)
    state = kfac.init_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, bundle_state({}, {}, kfac.state_dict(
        state, include_inverses=True), {}, step=0))
    sd = mgr.restore(0)['kfac']
    assert_same(sd, kfac.state_dict(state, include_inverses=True))
    back = kfac.load_state_dict(sd)
    assert_same(back, state)


# ---------------------------------------------------------------------------
# Through the CIFAR CLI
# ---------------------------------------------------------------------------

# 3 steps per epoch, 2 epochs, damped Cholesky inverses every 4.
ARGV = ['--model', 'resnet20', '--batch-size', '8', '--val-batch-size', '6',
        '--synthetic-size', '24', '--epochs', '2', '--device', 'cpu',
        '--kfac-update-freq', '4', '--use-inv-kfac', '--checkpoint-freq',
        '1', '--checkpoint-steps', '2', '--quiet']


def _run(directory, *extra):
    return cli.train(ARGV + ['--checkpoint-dir', str(directory), *extra],
                     device='cpu')


def _final(directory):
    return CheckpointManager(str(directory)).restore(1)


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp('reference')
    res = _run(d)
    return res, _final(d)


def _subprocess(directory, chaos):
    env = {**os.environ, 'KFAC_CHAOS': chaos, 'OMP_NUM_THREADS': '1'}
    proc = subprocess.run(
        [sys.executable, '-m',
         'distributed_kfac_pytorch_tpu_torch.train_cifar10_resnet', *ARGV,
         '--checkpoint-dir', str(directory)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    return proc.returncode, proc.stdout + proc.stderr


@pytest.mark.parametrize('chaos,labels', [
    ('crash@4', [2]),                        # killed before step 4's save
    ('crash-in-save@4', [2]),                # killed before its rename
    ('corrupt-ckpt@4,crash@5', [2, 4]),      # step 4's bundle bit-rotted
])
def test_unclean_kill_then_resume_equals_the_reference(
        tmp_path, monkeypatch, reference, chaos, labels):
    monkeypatch.delenv('KFAC_CHAOS', raising=False)
    rc, out = _subprocess(tmp_path, chaos)
    assert rc == 137, out[-2000:]
    steps = CheckpointManager(str(tmp_path / 'steps'))
    assert steps.all_steps() == labels
    assert os.path.isdir(tmp_path / 'steps' / '4.partial') == \
        chaos.startswith('crash-in-save')
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        res = _run(tmp_path)
    assert res['preempted'] is None
    assert_same(_final(tmp_path), reference[1])
    quarantined = [str(w.message) for w in caught
                   if 'quarantining' in str(w.message)]
    if chaos.startswith('corrupt-ckpt'):
        assert len(quarantined) == 1 and 'step checkpoint 4' in \
            quarantined[0], quarantined
        # Moved aside with its reason; the relaunch resumed from the
        # epoch-0 bundle (step 3) and saved step 5.
        path, reason = steps.quarantine_info(4)
        assert path == str(tmp_path / 'steps' / '4.quarantined')
        assert 'content digest mismatch' in reason
        assert steps.all_steps() == [2, 5]
    else:
        assert not quarantined


def test_preempt_then_resume_step_and_data_seed(tmp_path, monkeypatch,
                                                reference):
    monkeypatch.setenv('KFAC_CHAOS', 'preempt@4')
    first = _run(tmp_path, '--seed', '42')
    assert first['preempted']['global_step'] == 4
    monkeypatch.delenv('KFAC_CHAOS')
    with pytest.raises(SystemExit, match='no checkpoint for step 9'):
        _run(tmp_path, '--resume-step', '9')
    # --resume-step 2 resumes from step 2 over the newer step-4 bundle,
    # and --seed 9 yields to the bundle's data seed 42.
    res = _run(tmp_path, '--resume-step', '2', '--seed', '9')
    assert first['losses'][:2] + res['losses'] == reference[0]['losses']
    assert_same(_final(tmp_path), reference[1])


def test_no_resume_trains_from_scratch(tmp_path, reference):
    _run(tmp_path)
    again = _run(tmp_path, '--no-resume')
    assert again['losses'] == reference[0]['losses']
    assert_same(_final(tmp_path), reference[1])
    # Without --no-resume the finished run resumes at its end: no step.
    assert _run(tmp_path)['losses'] == []


def test_sgd_runs_checkpoint_into_the_sgd_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = [a for a in ARGV if a != '--use-inv-kfac']
    argv[argv.index('--kfac-update-freq') + 1] = '0'
    assert cli.main(argv) == 0
    sgd = CheckpointManager(str(tmp_path / 'checkpoints' / 'cifar10-sgd'))
    assert sgd.all_steps() == [0, 1]
    assert sgd.restore(1)['kfac'] == {}
    assert not (tmp_path / 'checkpoints' / 'cifar10').exists()


def test_main_returns_the_relaunch_code(tmp_path, monkeypatch):
    monkeypatch.setenv('KFAC_CHAOS', 'preempt@1')
    assert cli.main(ARGV + ['--checkpoint-dir', str(tmp_path)]) == \
        RELAUNCH_EXIT_CODE
    monkeypatch.delenv('KFAC_CHAOS')
    assert cli.main(ARGV + ['--checkpoint-dir', str(tmp_path)]) == 0
