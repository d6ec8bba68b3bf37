"""Checkpoints under ``--fp16`` and ``DistributedKFAC``: two LM CLI ranks
in a gloo group on the CPU, stopped after a step bundle and resumed,
write the uninterrupted world's bundle bit for bit, each rank's
loss-scale state included (a rank keeps it in its own file's
``extra_vars``, as the JAX CLIs keep it in ``extra_vars``). The
single-process carry is in ``tests/test_torch_fp16_cli.py``."""

import pathlib
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

LM_ARGV = ('--emsize', '8', '--nhid', '8', '--nlayers', '1',
           '--synthetic-vocab', '30', '--synthetic-size', '1000',
           '--bptt', '4', '--batch-size', '4', '--epochs', '1',
           '--kfac-update-freq', '2', '--fp16', '--device', 'cpu',
           '--quiet', '--checkpoint-steps', '1')


def _lm_world(directory, max_steps: int) -> None:
    """Two ranks of the LM CLI (module entry point) in a gloo group on the
    CPU, checkpointing every step under ``directory``."""
    import os
    import subprocess

    from test_torch_distributed import _free_port
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, 'RANK': str(rank), 'WORLD_SIZE': '2',
               'LOCAL_RANK': '0', 'MASTER_ADDR': '127.0.0.1',
               'MASTER_PORT': str(port), 'OMP_NUM_THREADS': '1'}
        env.pop('KFAC_CHAOS', None)
        procs.append(subprocess.Popen(
            [sys.executable, '-m',
             'distributed_kfac_pytorch_tpu_torch.train_language_model',
             *LM_ARGV, '--max-steps', str(max_steps), '--checkpoint-dir',
             str(directory)], cwd=HERE.parent, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs[0][-3000:]


def test_rank_bundles_carry_the_loss_scale(tmp_path):
    """``DistributedKFAC`` under ``--fp16``: two LM CLI ranks stopped
    after their step-2 bundle and resumed to step 4 write the step-4
    bundle the uninterrupted world writes, every rank's file (its K-FAC
    state and ``extra_vars``, the loss-scale state with its growth counter
    at 4 among them) bit for bit."""
    from distributed_kfac_pytorch_tpu_torch.training.checkpoint import \
        RANK_FILE
    from test_torch_resilience import _assert_same
    _lm_world(tmp_path / 'ref', 4)
    _lm_world(tmp_path / 'run', 2)
    _lm_world(tmp_path / 'run', 4)
    step = pathlib.Path('steps') / '4'
    files = sorted(p.name for p in (tmp_path / 'ref' / step).iterdir())
    assert files == ['bundle.pt', RANK_FILE.format(0), RANK_FILE.format(1)]
    for name in files:
        ref = torch.load(tmp_path / 'ref' / step / name, weights_only=True)
        got = torch.load(tmp_path / 'run' / step / name, weights_only=True)
        _assert_same(got, ref, name)
    for rank in range(2):
        extra = torch.load(tmp_path / 'run' / step / RANK_FILE.format(rank),
                           weights_only=True)['extra_vars']
        assert int(extra['loss_scale']['growth_count']) == 4
        assert float(extra['loss_scale']['scale']) == 2.0 ** 15
