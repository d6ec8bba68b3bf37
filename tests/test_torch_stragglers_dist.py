"""Straggler shards of the torch port on gloo ranks on the CPU: the CIFAR
CLI in 4 ranks (2 slices of 2) with ``--hierarchical-reduce
--kfac-metrics --straggler-shards --straggler-sample-every 2``, and a
2-rank flat run with the probe on every step, read back here.

Held: one shard per rank (``<metrics>.rank<r>``) with the rank and its
slice in the meta record and one step record per step; the barrier
probe's wait (``host/barrier_wait_ms``) on exactly the sampled steps (the
even ones; every step at ``--straggler-sample-every 1``); the window heads
of the hierarchical run labelled ``dcn_reduce`` in the rank-0 stream and
in the shards; the shards merged by the port's and the JAX package's
``merge_shards`` alike, and ``straggler_summary`` equal, with the per-slice
rows; the port's ``report --json`` equal to JAX's on the merged run.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from distributed_kfac_pytorch_tpu.observability import report as jreport
from distributed_kfac_pytorch_tpu.observability import \
    stragglers as jstragglers
from distributed_kfac_pytorch_tpu_torch.observability import report, \
    sink, stragglers

import test_torch_distributed as base

STEPS = 4


def run_ranks(world: int, code: str) -> None:
    """``python -c code`` in ``world`` processes with torchrun's
    environment (a free localhost port); each must exit 0."""
    port = base._free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, 'RANK': str(rank), 'LOCAL_RANK': str(rank),
               'WORLD_SIZE': str(world), 'MASTER_ADDR': '127.0.0.1',
               'MASTER_PORT': str(port), 'OMP_NUM_THREADS': '1',
               'PYTHONPATH': str(base.ROOT)}
        procs.append(subprocess.Popen(
            [sys.executable, '-c', code], cwd=base.ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        try:
            log, _ = p.communicate(timeout=base.WORLD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f'{world}-rank run hung')
        assert p.returncode == 0, log[-3000:]


def _cli(path, **extra) -> str:
    config = {'model': 'resnet20', 'batch_size': 16, 'val_batch_size': 4,
              'synthetic_size': 16 * STEPS, 'epochs': 1, 'no_augment': True,
              'kfac_update_freq': 2, 'use_inv_kfac': True, 'quiet': True,
              'kfac_metrics': str(path), 'metrics_interval': 1,
              'straggler_shards': True, **extra}
    return ('import torch\n'
            'torch.set_num_threads(1)\n'
            'from distributed_kfac_pytorch_tpu_torch import '
            'train_cifar10_resnet as T\n'
            f'T.train({config!r}, device="cpu")\n')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('shards')
    hier, flat = tmp / 'hier' / 'm.jsonl', tmp / 'flat' / 'm.jsonl'
    run_ranks(4, _cli(hier, num_slices=2, hierarchical_reduce=True,
                      straggler_sample_every=2))
    run_ranks(2, _cli(flat))
    return {'hier': str(hier), 'flat': str(flat)}


@pytest.mark.parametrize('which,world', [('hier', 4), ('flat', 2)])
def test_one_shard_per_rank_with_sampled_waits(runs, which, world):
    path = runs[which]
    assert sorted(stragglers.find_shards(path)) == list(range(world))
    shards, torn, errors = stragglers.merge_shards(path)
    assert torn == 0 and errors == {}
    every = 2 if which == 'hier' else 1
    for rank, records in shards.items():
        meta = [r for r in records if r['kind'] == 'meta']
        assert meta[0]['meta']['rank'] == rank
        assert meta[0]['meta']['process_count'] == world
        if which == 'hier':
            assert meta[0]['meta']['slice'] == rank // 2
        steps = [r for r in records if r['kind'] == 'step']
        assert [r['step'] for r in steps] == list(range(STEPS))
        waited = [r['step'] for r in steps
                  if stragglers.BARRIER_WAIT_KEY in r['metrics']]
        assert waited == [s for s in range(STEPS) if s % every == 0]
        assert all(r['metrics'][stragglers.BARRIER_WAIT_KEY] >= 0
                   for r in steps if r['step'] in waited)
        assert all(r['host_step_ms'] > 0 for r in steps)


def test_hierarchical_window_heads_are_dcn_reduce(runs):
    main = [r for r in sink.read_jsonl(runs['hier']) if r['kind'] == 'step']
    fired = [r.get('fired') for r in main]
    # Window heads (every 2nd step) carry the cross-slice reduction.
    assert fired[0] == 'inverse+dcn_reduce', fired
    assert fired[2] == 'inverse+dcn_reduce', fired
    shards, _, _ = stragglers.merge_shards(runs['hier'])
    for records in shards.values():
        labels = [r.get('fired') for r in records if r['kind'] == 'step']
        assert labels == fired
    flat = [r.get('fired') for r in sink.read_jsonl(runs['flat'])
            if r['kind'] == 'step']
    assert not any('dcn' in (f or '') for f in flat)


@pytest.mark.parametrize('which', ['hier', 'flat'])
def test_merge_and_summary_match_jax(runs, which):
    path = runs[which]
    shards, torn, errors = stragglers.merge_shards(path)
    jshards, jtorn, jerrors = jstragglers.merge_shards(path)
    assert (shards, torn, errors) == (jshards, jtorn, jerrors)
    summary = stragglers.straggler_summary(shards)
    assert summary == jstragglers.straggler_summary(jshards)
    assert summary['n_ranks'] == len(shards)
    if which == 'hier':
        assert sorted(summary['per_slice']) == [0, 1]
        assert 'dcn' in summary['wait_by_stage']
    buf, jbuf = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert report.main([path, '--json']) == 0
    with contextlib.redirect_stdout(jbuf):
        assert jreport.main([path, '--json']) == 0
    assert json.loads(buf.getvalue()) == json.loads(jbuf.getvalue())
