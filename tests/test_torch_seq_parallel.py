"""``DistributedKFAC`` of the torch port under sequence parallelism: the
ring over a ``torch.distributed`` sequence group inside the K-FAC step, on
real gloo process groups on the CPU, against the JAX ``DistributedKFAC``
on the matching ``(rows, cols, seq)`` mesh of the first 4 virtual CPU
devices and, under ``expand``, against the port's single-device ``KFAC``
on the full batch.

One 4-rank world of subprocesses (``test_torch_distributed``'s launcher;
the children never import JAX) runs the tiny tied Transformer of
``test_torch_distributed_lm`` (vocabulary 37, d 16, 1 block, 2 heads,
sequence 8, batch 8). World rank ``r`` is K-FAC rank ``r // sp`` at
sequence index ``r % sp`` and trains on its tile of one fixed batch
(``launch.process_local_tile``, ``pos_offset`` its block start), 3 steps,
factors every step and inverses every 2nd:

  - ``sp 4 x dp 1`` under ``expand`` (grid 1 x 1), eigen / ``'xla'``;
  - ``sp 2 x dp 2`` MEM_OPT (grid 2 x 1) under ``expand`` + ``newton``;
  - ``sp 2 x dp 2`` COMM_OPT (grid 1 x 2) under ``reduce`` (tied
    statistics on), Cholesky. Each rank reduces over its own 4 positions,
    as each JAX device does, so this step is not the single-device one.

Tolerances (``test_torch_distributed_lm``'s), on every step: factors,
the embedding's factor contribution and diagonal inverse within 1e-5 of
the largest reference entry, preconditioned gradients within 1e-4, the
KL-clip scale within 1e-5 relative, the parameters after 3 steps at
``rtol=1e-2, atol=1e-4``. Every rank's record must equal rank 0's
exactly; each rank's grid place and work follow its K-FAC rank. The LM
CLI also runs in two torchrun-style processes with ``--seq-parallel 2``.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from test_torch_distributed import _finish_world, _start_world, \
    run_two_ranks
from test_torch_distributed_lm import COMMON, LM_BATCH, LM_SEQ, LM_VOCAB, \
    STEPS, _check_steps, _inputs, _loss, _model, _rel, _run, port_run

WORLD = 4
# (name, seq_parallel, comm_method, grad_worker_fraction, grid, KFAC knobs)
CASES = [
    ('sp4_expand', 4, 'comm-opt', 0.0, (1, 1),
     dict(kfac_approx='expand', inverse_method='eigen', eigh_method='xla')),
    ('sp2_mem_opt_expand_newton', 2, 'mem-opt', 0.0, (2, 1),
     dict(kfac_approx='expand', inverse_method='newton')),
    ('sp2_comm_opt_reduce', 2, 'comm-opt', 0.0, (1, 2),
     dict(kfac_approx='reduce', inverse_method='cholesky')),
]
CASE_IDS = [c[0] for c in CASES]
# Records that differ between the ranks by design.
PER_RANK = ('place', 'groups', 'work')


def _case(name):
    return next(c for c in CASES if c[0] == name)


def worker_main():
    """One rank (``test_torch_distributed._start_world``)."""
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch import launch
    from distributed_kfac_pytorch_tpu_torch.parallel import sequence
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine

    cfg = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    meta = launch.initialize_distributed(
        init_method=f'file://{cfg["store"]}', device='cpu', timeout=120)
    rank = meta['process_index']
    data = np.load(cfg['data'])
    groups = {sp: sequence.make_sequence_group(sp)
              for sp in sorted({c[1] for c in CASES})}
    out = {}
    for name in cfg['cases']:
        _, sp, comm, frac, _, knobs = _case(name)
        params, x, y = _inputs('lm', data)
        rows, cols = launch.process_local_tile(*x.shape, sp)
        model = _model('lm', params, seq_group=groups[sp])
        kfac = KFAC(model, device='cpu', **COMMON, **knobs)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac, seq_parallel=sp)
        box = {'state': dk.init_state()}

        def step_fn(grads, captures, inv_update, dk=dk, box=box):
            contribs = dk.update_factors(
                box['state'], dk.local_factor_contribs(captures), 0.0)
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            precond, box['state'] = dk.step(box['state'], grads, captures,
                                             factor_update=True,
                                             inv_update=inv_update)
            st = box['state']
            return (precond, dk.last_nu, st['factors'], st['diag_inv'],
                    contribs)

        rec = _run(model, kfac, step_fn, _loss('lm', y[rows, cols]),
                   x[rows, cols], pos_offset=cols.start)
        rec['grid'] = np.asarray([dk.n_rows, dk.n_cols])
        rec['place'] = np.asarray([dk.row, dk.col])
        rec['groups'] = np.asarray(json.dumps(
            [dk.groups.inv_ranks, dk.groups.grad_ranks]))
        rec['work'] = np.asarray(json.dumps(dk.local_work()))
        rec['approx'] = np.asarray(json.dumps(kfac.approx_summary()))
        if knobs.get('eigh_method') == 'xla':
            rec.update(_seq_checkpoint_record(dk, box['state']))
        out.update({f'{name}|{k}': v for k, v in rec.items()})
    leaked = [m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'optax')]
    out['jax_modules'] = np.asarray(len(leaked))
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


def _seq_checkpoint_record(dk, state) -> dict:
    """Round trips of ``state_dict`` / ``load_state_dict``: as saved, and
    as if saved under another ``seq_parallel`` (every rank then recomputes
    its inverses from the factors, with the library eigh)."""
    def err(loaded):
        return np.asarray(max(
            float((loaded['inv_stacks'][d][k] - t).abs().max())
            for d, e in state['inv_stacks'].items() for k, t in e.items()))
    sd = dk.state_dict(state)
    assert sd['inv_layout']['seq_parallel'] == dk.seq_parallel
    other = {**sd, 'inv_layout': {**sd['inv_layout'], 'seq_parallel': 1},
             'inv_stacks': {d: {k: torch.zeros_like(t) for k, t in e.items()}
                            for d, e in sd['inv_stacks'].items()}}
    return {'reload_err': err(dk.load_state_dict(sd)),
            'rebuilt_err': err(dk.load_state_dict(other))}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from distributed_kfac_pytorch_tpu_torch import convert
    from test_torch_distributed_lm import _jax_model, jax_distributed_run

    tmp = tmp_path_factory.mktemp('kfac_seq_world')
    rng = np.random.default_rng(0)
    x = rng.integers(0, LM_VOCAB, (LM_BATCH, LM_SEQ)).astype(np.int32)
    y = rng.integers(0, LM_VOCAB, (LM_BATCH, LM_SEQ)).astype(np.int32)
    variables = _jax_model('lm').init(jax.random.PRNGKey(0), jnp.asarray(x),
                                      train=False)
    flax_params = jax.tree.map(np.asarray, variables['params'])
    data = tmp / 'data.npz'
    np.savez(data, **{'lm/x': x, 'lm/y': y}, **{
        f'lm/p/{k}': v.numpy()
        for k, v in convert.flax_to_torch(flax_params).items()})
    procs = _start_world(tmp, WORLD, CASE_IDS, data,
                         module='test_torch_seq_parallel')
    try:
        loaded = np.load(data)
        params, _, _ = _inputs('lm', loaded)
        specs = KFAC(_model('lm', params), device='cpu').specs
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        port = {c[0]: port_run('lm', c[5], loaded) for c in CASES}
        torch.set_num_threads(prev)
        ref = {c[0]: jax_distributed_run('lm', c[2], c[3], c[5],
                                         flax_params, x, y, specs,
                                         seq_parallel=c[1])
               for c in CASES}
    finally:
        ranks = _finish_world(procs, tmp, WORLD)
    dist = {name: [{k.split('|', 1)[1]: v for k, v in r.items()
                    if k.startswith(name + '|')} for r in ranks]
            for name in CASE_IDS}
    leaked = sum(int(r['jax_modules']) for r in ranks)
    return {'dist': dist, 'port': port, 'jax': ref, 'leaked': leaked}


def test_children_never_import_jax(runs):
    assert runs['leaked'] == 0


@pytest.mark.parametrize('name', CASE_IDS)
def test_grid_follows_the_kfac_rank(runs, name):
    """Rank ``r`` sits at K-FAC rank ``r // sp``'s grid place, its row and
    column groups hold the ranks of its sequence index, and the ``sp``
    ranks of one K-FAC rank have the same work."""
    _, sp, _, _, grid, _ = _case(name)
    recs = runs['dist'][name]
    work = {}
    for r, rec in enumerate(recs):
        k, j = divmod(r, sp)
        assert tuple(rec['grid']) == grid, r
        row, col = divmod(k, grid[1])
        assert tuple(rec['place']) == (row, col), r
        inv, grad = json.loads(str(rec['groups']))
        assert inv == [(row * grid[1] + c) * sp + j for c in range(grid[1])]
        assert grad == [(q * grid[1] + col) * sp + j for q in range(grid[0])]
        assert work.setdefault(k, str(rec['work'])) == str(rec['work']), r
    if grid == (1, 1):
        assert len(set(work.values())) == 1


@pytest.mark.parametrize('name', CASE_IDS)
def test_resolved_approx_matches_jax(runs, name):
    want = {k.replace('/', '.'): v
            for k, v in runs['jax'][name][1].items()}
    assert json.loads(str(runs['dist'][name][0]['approx'])) == want


@pytest.mark.parametrize('name', CASE_IDS)
def test_ranks_agree_exactly(runs, name):
    first, *rest = runs['dist'][name]
    for r, rec in enumerate(rest, start=1):
        assert set(rec) == set(first)
        for key in first:
            if key not in PER_RANK:
                np.testing.assert_array_equal(rec[key], first[key],
                                              err_msg=f'rank {r} {key}')


@pytest.mark.parametrize('name', CASE_IDS)
def test_matches_jax_distributed(runs, name):
    _check_steps(runs['dist'][name][0], runs['jax'][name][0],
                 'JAX DistributedKFAC')


@pytest.mark.parametrize('name', [c[0] for c in CASES
                                  if c[5]['kfac_approx'] == 'expand'])
def test_expand_matches_single_device_kfac(runs, name):
    got, want = runs['dist'][name][0], runs['port'][name]
    _check_steps(got, want, 'single-device KFAC')
    for step in range(STEPS):
        nu, nu_ref = float(got[f's{step}/nu']), float(want[f's{step}/nu'])
        assert abs(nu - nu_ref) <= 1e-5 * abs(nu_ref), step


def test_reduce_is_not_the_single_device_step(runs):
    """Under ``reduce`` each rank reduces over its own block of positions,
    as each JAX device does (held above): the A factors part from the
    single-device ``KFAC``'s reduction over whole sequences."""
    got = runs['dist']['sp2_comm_opt_reduce'][0]
    single = runs['port']['sp2_comm_opt_reduce']
    key = 's0/factor/block0.attn.q_proj/A'
    assert _rel(got[key], single[key]) > 1e-3


@pytest.mark.parametrize('name', [c[0] for c in CASES
                                  if c[5].get('eigh_method') == 'xla'])
def test_checkpoint_records_seq_parallel(runs, name):
    for r, rec in enumerate(runs['dist'][name]):
        assert float(rec['reload_err']) == 0.0, r
        assert float(rec['rebuilt_err']) == 0.0, r


def test_cli_seq_parallel_two_ranks_torchrun_style():
    """``train_language_model.train(..., device='cpu')`` with
    ``--seq-parallel 2`` in two torchrun-style processes: one K-FAC rank
    (grid 1 x 1) over a sequence group of both, the ring in every block;
    both ranks' losses equal, and equal within 1e-5 relative to the
    single-process run on the same windows (expand, exact eigh, dropout
    0: the same step)."""
    cfg = {'arch': 'transformer', 'emsize': 16, 'nheads': 2, 'nlayers': 1,
           'tied': True, 'synthetic_vocab': 40, 'synthetic_size': 2000,
           'bptt': 8, 'batch_size': 4, 'epochs': 1, 'max_steps': 3,
           'kfac_update_freq': 2, 'dropout': 0.0, 'inverse_method': 'eigen',
           'eigh_method': 'xla', 'quiet': True}
    code = (
        'import json, torch\n'
        'import torch.distributed as dist\n'
        'torch.set_num_threads(1)\n'
        'from distributed_kfac_pytorch_tpu_torch import '
        'train_language_model as T\n'
        f'r = T.train({{**{cfg!r}, "seq_parallel": 2}}, device="cpu")\n'
        "k = r['state'].kfac\n"
        "ring = r['state'].model.block0.attn.seq_group is not None\n"
        "print('RESULT', json.dumps({'losses': r['losses'], 'val': "
        "r['val']['loss'], 'kind': type(k).__name__, 'grid': "
        "[k.n_rows, k.n_cols], 'sp': k.seq_parallel, 'ring': ring, "
        "'world': dist.get_world_size()}))\n")
    results = run_two_ranks(code)
    assert results[0] == results[1]
    res = results[0]
    assert res['kind'] == 'DistributedKFAC' and res['grid'] == [1, 1]
    assert (res['sp'], res['ring'], res['world']) == (2, True, 2)
    from distributed_kfac_pytorch_tpu_torch import train_language_model
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = train_language_model.train(cfg, device='cpu')
    finally:
        torch.set_num_threads(prev)
    np.testing.assert_allclose(res['losses'], single['losses'], rtol=1e-5)
    np.testing.assert_allclose(res['val'], single['val']['loss'], rtol=1e-5)
