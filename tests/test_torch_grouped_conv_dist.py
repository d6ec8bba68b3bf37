"""Grouped and depthwise conv K-FAC (kind ``conv2d_grouped``) under
gradient accumulation and ``DistributedKFAC`` in the torch port, on the
CPU, with the JAX suite's ``DWNet`` (``tests/test_torch_grouped_conv.py``
has the net, the factors and the single-device knobs):

  - an accumulated step (``grad_accum=2``) against the JAX package's
    (``DistributedKFAC.build_train_step(grad_accum_steps=2)`` on a
    one-device mesh), two steps of factors and inverses;
  - the work placement: a grouped conv places no factor in a bucket and
    takes a row at the cost ``G (da^3 + dg^3)``;
  - ``DistributedKFAC`` on a 4-rank gloo world (children of
    ``test_torch_distributed``'s launcher that never import JAX) under
    COMM_OPT, MEM_OPT and HYBRID_OPT, one case with chunks, staleness,
    deferred reduction and ``factor_batch_fraction``, against the port's
    single-device ``KFAC`` on the full batch; every rank equal to rank 0,
    a window of chunk firings equal to a monolithic firing bit for bit,
    the grouped block stacks through ``state_dict`` / ``load_state_dict``
    and through a checkpoint bundle of every rank's file;
  - the ImageNet CLI training ``vit_cifar`` on two gloo ranks
    (``DistributedKFAC``), its bundle holding the ViT's parameters, and a
    relaunch resuming from it.

Tolerances, each relative to the largest reference entry of the tensor:
losses 1e-5, factors 1e-5, preconditioned gradients 1e-4, ``nu`` 1e-5.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from test_torch_grouped_conv import (  # noqa: E402
    COMMON,
    FACTOR_TOL,
    LR,
    NU_TOL,
    PRECOND_TOL,
    DWNet,
    _data,
    _flags,
    _model,
    _nchw,
    _rel,
)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Test files run in parallel processes next to JAX's virtual
    devices; one torch thread each keeps the machine from
    oversubscription."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# Gradient accumulation against the JAX accumulated step
# ---------------------------------------------------------------------------

ACCUM_STEPS = 2


def _jax_accum_run(n: int):
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from distributed_kfac_pytorch_tpu import CommMethod
    from distributed_kfac_pytorch_tpu.parallel import distributed as JD
    from test_grouped_conv import DWNet as JDWNet
    x, y = _data()
    kfac = JKFAC(JDWNet(), **COMMON, inverse_method='eigen',
                 eigh_method='xla')
    variables, _ = kfac.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = variables['params']
    init = jax.tree.map(np.asarray, params)
    mesh = JD.make_kfac_mesh(devices=jax.devices()[:1],
                             comm_method=CommMethod.COMM_OPT)
    dk = JD.DistributedKFAC(kfac, mesh, params)
    kstate = dk.init_state(params)
    tx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(lambda g: -LR * g, u), u))
    opt_state = tx.init(params)

    def loss_fn(out, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            out, batch[1]).mean()

    step = dk.build_train_step(loss_fn, tx, grad_accum_steps=n,
                               donate=False)
    recs = []
    for _ in range(ACCUM_STEPS):
        params, opt_state, kstate, _, metrics = step(
            params, opt_state, kstate, {}, (jnp.asarray(x), jnp.asarray(y)),
            {'lr': LR, 'damping': COMMON['damping']}, factor_update=True,
            inv_update=True)
        recs.append({'loss': float(metrics['loss']),
                     'factors': jax.tree.map(np.asarray, kstate['factors']),
                     'precond': jax.tree.map(np.asarray, opt_state)})
    return init, recs


def test_accumulated_step_matches_jax():
    init, jrecs = _jax_accum_run(2)
    model = _model(init)
    kfac = KFAC(model, device='cpu', **COMMON, inverse_method='eigen',
                eigh_method='xla')
    state = engine.TrainState(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=LR),
        kfac=kfac, kfac_state=kfac.init_state(), grad_accum=2)
    x, y = _data()
    for jr in jrecs:
        loss, _ = engine.train_step(
            state, _nchw(x), torch.from_numpy(y).long(),
            {'lr': LR, 'damping': COMMON['damping']},
            {'factor_update': True, 'inv_update': True})
        assert abs(float(loss) - jr['loss']) <= 1e-5 * abs(jr['loss'])
        want = convert.jax_factors_to_torch(jr['factors'], kfac.specs)
        for name, f in want.items():
            for side in 'AG':
                assert _rel(state.kfac_state['factors'][name][side],
                            f[side]) <= FACTOR_TOL, (name, side)
        want = convert.flax_to_torch(jr['precond'])
        for name, p in model.named_parameters():
            assert _rel(p.grad, want[name]) <= PRECOND_TOL, name


# ---------------------------------------------------------------------------
# DistributedKFAC on a 4-rank gloo world
# ---------------------------------------------------------------------------

WORLD, WORLD_STEPS = 4, 5
# (name, comm_method, grad_worker_fraction, grid, KFAC knobs)
WORLD_CASES = [
    ('comm_opt_xla', 'comm-opt', 0.0, (1, 4),
     dict(inverse_method='eigen', eigh_method='xla')),
    ('mem_opt_cholesky', 'mem-opt', 0.0, (4, 1),
     dict(inverse_method='cholesky')),
    ('hybrid_newton_packed', 'hybrid-opt', 0.5, (2, 2),
     dict(inverse_method='newton', symmetry_aware_comm=True)),
    ('hybrid_schedule', 'hybrid-opt', 0.5, (2, 2),
     dict(inverse_method='eigen', eigh_method='xla', inv_pipeline_chunks=2,
          inv_staleness=1, deferred_factor_reduction=True,
          factor_batch_fraction=0.5)),
]
WORLD_IDS = [c[0] for c in WORLD_CASES]


def _world_case(name):
    return next(c for c in WORLD_CASES if c[0] == name)


def _world_run(model, kfac, step_fn, x, y, knobs) -> dict:
    rec = {}
    for step in range(WORLD_STEPS):
        _, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, y), x)
        precond, nu, factors = step_fn(grads, captures,
                                       _flags(knobs, step))
        rec[f'nu/{step}'] = np.asarray(float(nu))
        for n, f in factors.items():
            for side, t in f.items():
                rec[f'factor/{step}/{n}/{side}'] = t.numpy().copy()
        for n, g in precond.items():
            rec[f'precond/{step}/{n}'] = g.numpy().copy()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * precond[n]
    return rec


def _world_model(params) -> DWNet:
    model = DWNet()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def _frozen_window_equal(dk, state) -> bool:
    """A window of chunk firings over the state's factors against a
    monolithic firing, bit for bit, the grouped block stacks included."""
    if not dk.kfac.pipelined_firing:
        return True
    mono = dk.update_inverses(state['factors'], None, state['inv_stacks'])
    cur = {k: state[k] for k in ('inv_stacks', 'diag_inv', 'grouped_inv')}
    for j in range(dk.kfac.inv_pipeline_chunks):
        cur = dk.update_inverses(state['factors'], None, cur['inv_stacks'],
                                 chunk=j, prev_diag=cur['diag_inv'],
                                 prev_grouped=cur['grouped_inv'])
    return (all(torch.equal(cur['inv_stacks'][d][k], t)
                for d, e in mono['inv_stacks'].items()
                for k, t in e.items())
            and all(torch.equal(cur['grouped_inv'][n][k], t)
                    for n, e in mono['grouped_inv'].items()
                    for k, t in e.items()))


def _bundle_round_trip(dk, model, state, directory) -> bool:
    """This rank's state through a checkpoint bundle (rank 0's
    ``bundle.pt`` and every rank's ``kfac_rank<r>.pt``): the factors,
    the row stacks, the grouped block stacks and the firing-schedule state
    come back bit for bit."""
    from distributed_kfac_pytorch_tpu_torch.training import checkpoint
    mgr = checkpoint.CheckpointManager(str(directory))
    mgr.save(1, checkpoint.bundle_state(model.state_dict(), {},
                                        dk.state_dict(state), {}, {},
                                        integrity='template', step=1))
    back = dk.load_state_dict(mgr.restore(1)['kfac'])
    keys = ('factors', 'grouped_inv', 'factor_accum', 'frozen_factors')
    same = [torch.equal(back[key][n][k], t)
            for key in keys if key in state
            for n, e in state[key].items() for k, t in e.items()]
    same += [torch.equal(back['inv_stacks'][d][k], t)
             for d, e in state['inv_stacks'].items() for k, t in e.items()]
    return all(same) and set(back['grouped_inv']) == {'dw', 'grouped'}


def worker_main():
    """One rank (``test_torch_distributed._start_world`` with
    ``module='test_torch_grouped_conv_dist'``)."""
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch import launch
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC

    cfg = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    meta = launch.initialize_distributed(
        init_method=f'file://{cfg["store"]}', device='cpu', timeout=120)
    rank = meta['process_index']
    data = np.load(cfg['data'])
    params = {k[len('p/'):]: data[k] for k in data.files
              if k.startswith('p/')}
    x, y = torch.from_numpy(data['x']), torch.from_numpy(data['y'])
    local = launch.process_local_slice(len(x))
    out = {}
    for name in cfg['cases']:
        _, comm, frac, _, knobs = _world_case(name)
        model = _world_model(params)
        kfac = KFAC(model, device='cpu', **COMMON, **knobs)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac)
        box = {'state': dk.init_state()}

        def step_fn(grads, captures, flags, dk=dk, box=box):
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            precond, box['state'] = dk.step(box['state'], grads, captures,
                                             **flags)
            return precond, dk.last_nu, box['state']['factors']

        rec = _world_run(model, kfac, step_fn, x[local], y[local], knobs)
        state = box['state']
        rec['grid'] = np.asarray([dk.n_rows, dk.n_cols])
        rec['grouped_layers'] = np.asarray(
            sorted(dk.assignment.grouped_layers))
        rec['frozen_window_equal'] = np.asarray(
            _frozen_window_equal(dk, state))
        loaded = dk.load_state_dict(dk.state_dict(state))
        rec['reload_same'] = np.asarray(all(
            torch.equal(loaded['grouped_inv'][n][k], t)
            for n, e in state['grouped_inv'].items() for k, t in e.items()))
        rec['bundle_same'] = np.asarray(_bundle_round_trip(
            dk, model, state, pathlib.Path(cfg['out']) / name))
        out.update({f'{name}|{k}': v for k, v in rec.items()})
    leaked = [m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'optax')]
    out['jax_modules'] = np.asarray(len(leaked))
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


def port_reference(name, params, x, y) -> dict:
    """The port's single-device ``KFAC`` on the full batch, firing the
    grid's chunk plan under chunks (``parallel.distributed.
    item_chunk_plan``)."""
    from distributed_kfac_pytorch_tpu_torch.parallel import distributed as D
    _, _, _, grid, knobs = _world_case(name)
    model = _world_model(params)
    kfac = KFAC(model, device='cpu', **COMMON, **knobs)
    if kfac.pipelined_firing:
        assignment = D.assign_work(kfac, *grid)
        plan = D.item_chunk_plan(assignment,
                                 D.plan_firing_chunks(kfac, assignment))
        kfac.inverse_chunk_plan = lambda factors: plan
    box = {'state': kfac.init_state()}

    def step_fn(grads, captures, flags):
        precond, box['state'] = kfac.step(box['state'], grads, captures,
                                          **flags)
        return precond, kfac.last_nu, box['state']['factors']

    return _world_run(model, kfac, step_fn, torch.from_numpy(x),
                      torch.from_numpy(y), knobs)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    from test_torch_distributed import _finish_world, _start_world
    tmp = tmp_path_factory.mktemp('grouped_world')
    torch.manual_seed(0)
    params = {k: v.numpy().copy() for k, v in DWNet().state_dict().items()}
    x, y = _data()
    x = _nchw(x).numpy()
    y = y.astype(np.int64)
    data = tmp / 'data.npz'
    np.savez(data, x=x, y=y, **{f'p/{k}': v for k, v in params.items()})
    procs = _start_world(tmp, WORLD, WORLD_IDS, data,
                         module='test_torch_grouped_conv_dist')
    try:
        refs = {name: port_reference(name, params, x, y)
                for name in WORLD_IDS}
    finally:
        ranks = _finish_world(procs, tmp, WORLD)
    return ranks, refs


def test_world_children_never_import_jax(world):
    ranks, _ = world
    assert all(int(r['jax_modules']) == 0 for r in ranks)


@pytest.mark.parametrize('name', WORLD_IDS)
def test_world_matches_single_device(world, name):
    ranks, refs = world
    rank0, ref = ranks[0], refs[name]
    assert tuple(rank0[f'{name}|grid']) == _world_case(name)[3]
    assert list(rank0[f'{name}|grouped_layers']) == ['dw', 'grouped']
    tol = {'factor': FACTOR_TOL, 'precond': PRECOND_TOL, 'nu': NU_TOL}
    for key, want in ref.items():
        err = _rel(rank0[f'{name}|{key}'], want)
        assert err <= tol[key.split('/')[0]], (key, err)


@pytest.mark.parametrize('name', WORLD_IDS)
def test_world_ranks_agree_and_reload(world, name):
    ranks, _ = world
    keys = [k for k in ranks[0] if k.startswith(f'{name}|')]
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    for r in ranks:
        assert bool(r[f'{name}|frozen_window_equal'])
        assert bool(r[f'{name}|reload_same'])
        assert bool(r[f'{name}|bundle_same'])


def test_placement_of_grouped_layers():
    """A grouped conv places no factor in a bucket, takes a row at the
    cost G (da^3 + dg^3), and is preconditioned by that row only."""
    from distributed_kfac_pytorch_tpu_torch.parallel import distributed as D
    kfac = KFAC(DWNet(), device='cpu', **COMMON)
    for grid in ((1, 4), (4, 1), (2, 2)):
        a = D.assign_work(kfac, *grid)
        assert a.grouped_layers == ('dw', 'grouped')
        placed = {key[0] for plan in a.buckets.values() for key in plan.slot}
        assert placed == {'pw', 'head'}
        assert set(a.layer_row) == set(kfac.specs)
        groups = D.plan_precond_groups(kfac, a)
        assert {n for g in groups for n in g['slot_of']} == {'pw', 'head'}
    # MEM_OPT on 4 rows: the largest cost (grouped, 2 * (37^3 + 8^3))
    # takes a row of its own.
    a = D.assign_work(kfac, 4, 1)
    rows = [a.layer_row[n] for n in ('pw', 'dw', 'grouped', 'head')]
    assert len(set(rows)) == 4


def test_imagenet_cli_trains_vit_on_two_ranks(tmp_path):
    """The ImageNet CLI at ``--model vit_cifar`` in two processes with
    torchrun's environment: a gloo group, ``DistributedKFAC`` under
    HYBRID_OPT (grid 2 x 1), both ranks' losses equal and finite; its
    epoch bundle holds the ViT's parameters (``cls_token``, ``pos_embed``,
    the patch conv) and each rank's K-FAC file, and a relaunch resumes
    from it."""
    from test_torch_distributed import run_two_ranks

    from distributed_kfac_pytorch_tpu_torch.training import checkpoint
    code = (
        'import json, torch\n'
        'torch.set_num_threads(1)\n'
        'from distributed_kfac_pytorch_tpu_torch import '
        'train_imagenet_resnet as T\n'
        "cfg = {'model': 'vit_cifar', 'image_size': 32, 'batch_size': 4, "
        "'val_batch_size': 4, 'synthetic_size': 8, 'epochs': 1, "
        "'kfac_update_freq': 1, 'kfac_cov_update_freq': 1, 'quiet': True, "
        "'comm_method': 'hybrid-opt', 'grad_worker_fraction': 0.5, "
        f"'checkpoint_dir': {str(tmp_path / 'ck')!r}}}\n"
        "r = T.train(cfg, device='cpu')\n"
        "again = T.train({**cfg, 'epochs': 2}, device='cpu')\n"
        "k = r['state'].kfac\n"
        "print('RESULT', json.dumps({'losses': r['losses'], 'kind': "
        "type(k).__name__, 'grid': [k.n_rows, k.n_cols], "
        "'again': again['losses'], 'steps': again['steps']}))\n")
    results = run_two_ranks(code)
    assert results[0] == results[1]
    res = results[0]
    assert res['kind'] == 'DistributedKFAC' and res['grid'] == [2, 1]
    assert len(res['losses']) == 2 and all(np.isfinite(res['losses']))
    # The relaunch resumed at epoch 1: two more steps, not four.
    assert len(res['again']) == 2 and all(np.isfinite(res['again']))
    ck = tmp_path / 'ck'
    assert sorted(p.name for p in (ck / '0').iterdir()
                  if p.name.startswith('kfac_rank')) == [
        'kfac_rank0.pt', 'kfac_rank1.pt']
    tree = torch.load(ck / '0' / 'bundle.pt', weights_only=True)
    params = tree['params']
    assert tuple(params['cls_token'].shape) == (1, 1, 192)
    assert tuple(params['pos_embed'].shape) == (65, 192)
    assert tuple(params['patch_embed.weight'].shape) == (192, 3, 4, 4)
    assert checkpoint.RANK_FILE.format(0) == 'kfac_rank0.pt'
