"""Preempt, relaunch, resume: a run of a port CLI preempted at step K
(``KFAC_CHAOS=preempt@K``, which drains into a forced blocking bundle and
returns the relaunch code) and relaunched ends equal, bit for bit, to the
uninterrupted run: every tensor of its final epoch bundle (parameters,
BatchNorm buffers, momentum, factors, inverses and warm-polish bases, the
firing-schedule state, the dropout generator) and every scalar. K sits
where a missing piece of state would show: before a firing, in the middle
of a pipelined window, at a window head of the deferred reduction, between
a stale window's snapshot and its firing."""

import pytest
import torch

from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cli
from distributed_kfac_pytorch_tpu_torch import train_language_model as lm
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import \
    RELAUNCH_EXIT_CODE
from distributed_kfac_pytorch_tpu_torch.training import engine
from distributed_kfac_pytorch_tpu_torch.training.checkpoint import \
    CheckpointManager


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_same(a, b, path='bundle'):
    """Every tensor equal bit for bit (dtype and shape included), every
    other leaf equal, the same keys."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), path
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


def final_bundle(directory, label):
    return CheckpointManager(str(directory)).restore(label)


# 3 steps per epoch (24 images, batch 8), 2 epochs, factors every step,
# inverses every 4: firings (or window heads) at steps 0 and 4.
CIFAR = ['--model', 'resnet20', '--batch-size', '8', '--val-batch-size',
         '6', '--synthetic-size', '24', '--epochs', '2', '--device', 'cpu',
         '--kfac-update-freq', '4', '--checkpoint-freq', '1',
         '--checkpoint-steps', '2', '--quiet']


def preempt_and_resume(module, argv, tmp_path, monkeypatch, k,
                       last_label):
    """The uninterrupted run, the run preempted at step ``k`` and its
    relaunch; returns both final bundles and the three runs' losses."""
    monkeypatch.delenv('KFAC_CHAOS', raising=False)
    ref = module.train(argv + ['--checkpoint-dir', str(tmp_path / 'ref')],
                       device='cpu')
    assert ref['preempted'] is None
    run = argv + ['--checkpoint-dir', str(tmp_path / 'run')]
    monkeypatch.setenv('KFAC_CHAOS', f'preempt@{k}')
    first = module.train(run, device='cpu')
    assert first['preempted'] == {'global_step': k,
                                  'reason': 'injected preemption'}
    assert k in CheckpointManager(str(tmp_path / 'run' / 'steps')
                                  ).all_steps()
    monkeypatch.delenv('KFAC_CHAOS')
    second = module.train(run, device='cpu')
    assert second['preempted'] is None
    assert first['losses'] + second['losses'] == ref['losses']
    return (final_bundle(tmp_path / 'ref', last_label),
            final_bundle(tmp_path / 'run', last_label))


# Besides 'auto' (the eigen path: the warm-polish bases must survive), the
# schedule cases run the damped Cholesky (--use-inv-kfac), which keeps the
# CPU run short.
@pytest.mark.parametrize('flags,k', [
    ([], 3),                                    # before the step-4 firing
    (['--inv-pipeline-chunks', '2', '--use-inv-kfac'], 3),
                                                # mid-window, chunk 1 done
    (['--inv-staleness', '1', '--use-inv-kfac'], 4),
                                                # after a window-head
                                                # snapshot, before its firing
    (['--deferred-factor-reduction', '--use-inv-kfac'], 4),
                                                # resumes at a window head
    (['--inv-pipeline-chunks', '2', '--deferred-factor-reduction',
      '--use-inv-kfac'], 5),                    # chunk 0 and the reduce done
], ids=['auto', 'chunks2', 'staleness1', 'deferred', 'chunks2_deferred'])
def test_cifar_cli_preempt_resume_is_bit_identical(tmp_path, monkeypatch,
                                                    flags, k):
    ref, got = preempt_and_resume(cli, CIFAR + flags, tmp_path, monkeypatch,
                                  k, last_label=1)
    assert_same(got, ref)
    assert ref['scalars']['step'] == 6 and ref['scalars']['epoch'] == 2
    if '--inv-staleness' in flags:
        assert 'frozen_factors' in ref['kfac']
    if '--deferred-factor-reduction' in flags:
        assert {'factor_accum', 'accum_decay'} <= set(ref['kfac'])
    kinds = {k for e in ref['kfac']['inverses'].values() for k in e}
    assert kinds == ({'A_inv', 'G_inv'} if '--use-inv-kfac' in flags
                     else {'QA', 'dA', 'QG', 'dG'})


# 10 BPTT windows of 4 x 6 tokens per epoch, dropout 0.5 drawn from each
# run's generator, inverses every 3.
LSTM = ['--emsize', '16', '--nhid', '16', '--batch-size', '4', '--bptt',
        '6', '--synthetic-size', '260', '--synthetic-vocab', '30',
        '--dropout', '0.5', '--epochs', '2', '--device', 'cpu',
        '--kfac-update-freq', '3', '--checkpoint-freq', '1',
        '--checkpoint-steps', '4', '--quiet']


@pytest.mark.parametrize('method,k', [('newton', 5), ('eigen', 11)])
def test_lstm_lm_cli_preempt_resume_with_dropout(tmp_path, monkeypatch,
                                                 method, k):
    ref, got = preempt_and_resume(lm, LSTM + ['--inverse-method', method],
                                  tmp_path, monkeypatch, k, last_label=1)
    assert_same(got, ref)
    assert ref['extra_vars']['dropout_generator'].dtype == torch.uint8
    assert ref['scalars']['step'] == 20


@pytest.mark.parametrize('module,argv,evaluate,per_epoch', [
    (cli, CIFAR + ['--use-inv-kfac'], 'evaluate', 3),
    (lm, LSTM + ['--inverse-method', 'newton'], 'evaluate_lm', 10),
], ids=['cifar', 'lstm'])
def test_notice_during_evaluation_drains_at_the_epoch_boundary(
        tmp_path, monkeypatch, module, argv, evaluate, per_epoch):
    """A notice that lands while epoch 0 evaluates (the
    ``KFAC_PREEMPT_FILE`` sentinel) drains at the next epoch's poll:
    ``main()`` returns the relaunch code with a step bundle at the epoch
    boundary, and the relaunch ends equal to the uninterrupted run."""
    monkeypatch.delenv('KFAC_CHAOS', raising=False)
    assert module.main(argv + ['--checkpoint-dir',
                               str(tmp_path / 'ref')]) == 0
    sentinel = tmp_path / 'preempt-now'
    monkeypatch.setenv('KFAC_PREEMPT_FILE', str(sentinel))
    real = getattr(engine, evaluate)

    def touch_then_evaluate(*a, **kw):
        sentinel.touch()
        return real(*a, **kw)

    monkeypatch.setattr(engine, evaluate, touch_then_evaluate)
    run = argv + ['--checkpoint-dir', str(tmp_path / 'run')]
    assert module.main(run) == RELAUNCH_EXIT_CODE
    steps = CheckpointManager(str(tmp_path / 'run' / 'steps'))
    drained = steps.restore(steps.latest_epoch())['scalars']
    assert (drained['step'], drained['epoch'], drained['step_in_epoch']) \
        == (per_epoch, 1, 0)
    monkeypatch.setattr(engine, evaluate, real)
    sentinel.unlink()
    assert module.main(run) == 0
    assert_same(final_bundle(tmp_path / 'run', 1),
                final_bundle(tmp_path / 'ref', 1))
