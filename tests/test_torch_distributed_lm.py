"""``DistributedKFAC`` of the torch port over models with an embedding, on
real ``torch.distributed`` process groups on the CPU (gloo): the diagonal
A of an embedding, a tied embedding's attend-site statistics and
KFAC-reduce, against the port's single-device ``KFAC`` on the full batch
and against the JAX ``DistributedKFAC`` on the same grid (the first 4 of
the 8 virtual CPU devices).

One 4-rank world of subprocesses (``test_torch_distributed``'s launcher:
a ``file://`` store under ``tmp_path``; the children never import JAX)
runs every case in turn, each rank on its slice of one fixed batch, 3
steps, factors every step and inverses every 2nd:

  - the JAX suite's ``EmbedNet`` (embedding 32 x 12, mean over 6 ids,
    dense 16, dense 5) under COMM_OPT (1 x 4), MEM_OPT (4 x 1) and
    HYBRID_OPT (fraction 0.5: 2 x 2), batch 16;
  - the tiny tied Transformer of ``tests/test_sharing.py`` (vocabulary
    37, d 16, 1 block, 2 heads, sequence 8), batch 8, under ``expand``
    and under ``reduce`` (tied statistics on), and under ``reduce`` with
    ``'newton'`` and ``symmetry_aware_comm``.

Tolerances (``test_torch_distributed``'s), on every step: factors and the
embeddings' diagonal inverses within 1e-5 of the largest reference entry,
preconditioned gradients within 1e-4 (per tensor), the KL-clip scale
within 1e-5 relative, the parameters after 3 steps at ``rtol=1e-2,
atol=1e-4``. Every rank's record must equal rank 0's exactly.

The LM CLI also runs in two torchrun-style processes (``--arch lstm``,
and ``--arch transformer --tied --kfac-approx reduce``).
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from distributed_kfac_pytorch_tpu_torch.models import transformer_lm
from distributed_kfac_pytorch_tpu_torch.modules.embed import Embed
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine
from test_torch_distributed import _check, _checkpoint_record, \
    _finish_world, _rel, _start_world, run_two_ranks

HERE = pathlib.Path(__file__).resolve().parent

STEPS, INV_FREQ, LR = 3, 2, 0.1
COMMON = dict(factor_update_freq=1, inv_update_freq=INV_FREQ,
              damping=0.003, lr=LR, kl_clip=0.001)
WORLD = 4
EMBED_BATCH, EMBED_IDS, EMBED_VOCAB, EMBED_CLASSES = 16, 6, 32, 5
LM_VOCAB, LM_D, LM_HEADS, LM_SEQ, LM_BATCH = 37, 16, 2, 8, 8
# (name, model, comm_method, grad_worker_fraction, grid, KFAC knobs)
CASES = [
    ('embed_comm_opt', 'embed', 'comm-opt', 0.0, (1, 4),
     dict(inverse_method='eigen', eigh_method='xla')),
    ('embed_mem_opt', 'embed', 'mem-opt', 0.0, (4, 1),
     dict(inverse_method='eigen', eigh_method='xla')),
    ('embed_hybrid_opt', 'embed', 'hybrid-opt', 0.5, (2, 2),
     dict(inverse_method='cholesky')),
    ('lm_expand', 'lm', 'hybrid-opt', 0.5, (2, 2),
     dict(kfac_approx='expand', inverse_method='eigen', eigh_method='xla')),
    ('lm_reduce', 'lm', 'mem-opt', 0.0, (4, 1),
     dict(kfac_approx='reduce', inverse_method='cholesky')),
    ('lm_reduce_newton_packed', 'lm', 'hybrid-opt', 0.5, (2, 2),
     dict(kfac_approx='reduce', inverse_method='newton',
          symmetry_aware_comm=True)),
]
CASE_IDS = [c[0] for c in CASES]


def _case(name):
    return next(c for c in CASES if c[0] == name)


class EmbedNet(nn.Module):
    """Torch twin of the JAX suite's ``EmbedNet``."""

    def __init__(self):
        super().__init__()
        self.embed = Embed(EMBED_VOCAB, 12)
        self.fc1 = nn.Linear(12, 16)
        self.fc2 = nn.Linear(16, EMBED_CLASSES)

    def forward(self, ids):
        return self.fc2(self.fc1(self.embed(ids).mean(dim=1)))


def _model(kind, params, seq_group=None):
    if kind == 'embed':
        model = EmbedNet()
    else:
        model = transformer_lm.TransformerLM(
            LM_VOCAB, d_model=LM_D, num_layers=1, num_heads=LM_HEADS,
            max_len=LM_SEQ, dropout=0.0, tie_weights=True,
            seq_group=seq_group)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def _loss(kind, y):
    if kind == 'embed':
        return lambda out: F.cross_entropy(out, y)
    return lambda out: engine.lm_loss(out, y)


def _run(model, kfac, step_fn, loss_fn, x, **model_kwargs):
    """Three K-FAC + SGD steps (``model_kwargs`` go to the model's
    forward); the record holds every step's factors,
    the embedding's factor contribution on its own scale (the factor
    update at decay 0: next to the running factor, the tied attend-site
    term of its A is ~1e-5), diagonal inverses, preconditioned gradients
    and KL-clip scale, and the parameters after the last step. (Other
    layers' contributions are not held on their own scale: under reduce,
    the key projection's G sums output-grads that cancel to ~1e-19.)"""
    rec = {}
    for step in range(STEPS):
        _, _, grads, captures = kfac.capture.loss_and_grads(
            loss_fn, x, **model_kwargs)
        precond, nu, factors, diag_inv, contribs = step_fn(
            grads, captures, step % INV_FREQ == 0)
        rec[f's{step}/nu'] = np.asarray(float(nu))
        for side, t in contribs['embed'].items():
            rec[f's{step}/contrib/embed/{side}'] = t.numpy().copy()
        for n, f in factors.items():
            for side, t in f.items():
                rec[f's{step}/factor/{n}/{side}'] = t.numpy().copy()
        for n, t in diag_inv.items():
            rec[f's{step}/diag_inv/{n}'] = t.numpy().copy()
        for n, g in precond.items():
            rec[f's{step}/precond/{n}'] = g.numpy().copy()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * precond[n]
    for n, p in model.named_parameters():
        rec[f'param/{n}'] = p.detach().numpy().copy()
    return rec


def _inputs(kind, data):
    x, y = (torch.from_numpy(data[f'{kind}/{k}']).long() for k in 'xy')
    params = {k.split('/', 2)[2]: data[k] for k in data.files
              if k.startswith(f'{kind}/p/')}
    return params, x, y


def port_reference(name, data):
    """The port's single-device ``KFAC`` on the full batch."""
    _, kind, _, _, _, knobs = _case(name)
    return port_run(kind, knobs, data)


def port_run(kind, knobs, data):
    """The port's single-device ``KFAC`` with ``knobs`` on the full batch
    of ``kind``."""
    params, x, y = _inputs(kind, data)
    model = _model(kind, params)
    kfac = KFAC(model, device='cpu', **COMMON, **knobs)
    box = {'state': kfac.init_state()}

    def step_fn(grads, captures, inv_update):
        contribs = kfac.update_factors(box['state'], captures, 0.0)
        precond, box['state'] = kfac.step(box['state'], grads, captures,
                                          factor_update=True,
                                          inv_update=inv_update)
        st = box['state']
        return precond, kfac.last_nu, st['factors'], {
            n: e['A_inv'] for n, e in st['inverses'].items()
            if kfac.specs[n].kind == 'embedding'}, contribs

    return _run(model, kfac, step_fn, _loss(kind, y), x)


def worker_main():
    """One rank (``test_torch_distributed._start_world``)."""
    import sys

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
    out = {}
    for name in cfg['cases']:
        _, kind, comm, frac, _, knobs = _case(name)
        params, x, y = _inputs(kind, data)
        local = launch.process_local_slice(len(x))
        model = _model(kind, params)
        kfac = KFAC(model, device='cpu', **COMMON, **knobs)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac)
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

        rec = _run(model, kfac, step_fn, _loss(kind, y[local]), x[local])
        rec['grid'] = np.asarray([dk.n_rows, dk.n_cols])
        rec['approx'] = np.asarray(json.dumps(kfac.approx_summary()))
        if knobs.get('eigh_method') == 'xla':
            rec.update(_checkpoint_record(dk, box['state'], rank))
        out.update({f'{name}|{k}': v for k, v in rec.items()})
    leaked = [m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'optax')]
    out['jax_modules'] = np.asarray(len(leaked))
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The JAX DistributedKFAC on the same grid
# ---------------------------------------------------------------------------

def _jax_model(kind, seq_axis=None):
    from distributed_kfac_pytorch_tpu.models import transformer_lm as jtl
    if kind == 'embed':
        from test_distributed import EmbedNet as JaxEmbedNet
        return JaxEmbedNet()
    return jtl.TransformerLM(vocab_size=LM_VOCAB, d_model=LM_D,
                             num_layers=1, num_heads=LM_HEADS,
                             max_len=LM_SEQ, dropout=0.0, tie_weights=True,
                             seq_axis=seq_axis)


def jax_reference(name, flax_params, x, y, specs):
    """Three steps of the JAX ``build_train_step`` on the grid's mesh; the
    optimizer keeps each step's preconditioned gradients in its state.
    ``specs``: the port's, to convert the factors."""
    _, kind, comm, frac, _, knobs = _case(name)
    return jax_distributed_run(kind, comm, frac, knobs, flax_params, x, y,
                               specs)


def jax_distributed_run(kind, comm, frac, knobs, flax_params, x, y, specs,
                        seq_parallel=1):
    """:func:`jax_reference` for ``kind`` under ``comm`` / ``frac`` and
    the KFAC ``knobs`` on the ``(rows, cols[, seq])`` mesh of the first
    WORLD devices; with ``seq_parallel > 1`` the LM's sequences are
    sharded over the mesh's sequence axis and attention runs as JAX's
    ring (each device's ``pos_offset`` its block start)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from distributed_kfac_pytorch_tpu import KFAC as JKFAC
    from distributed_kfac_pytorch_tpu import CommMethod as JCommMethod
    from distributed_kfac_pytorch_tpu.parallel import distributed as JD
    from distributed_kfac_pytorch_tpu.parallel import sequence as jseq
    from distributed_kfac_pytorch_tpu_torch import convert

    lm = kind == 'lm'
    ring = seq_parallel > 1
    kfac = JKFAC(_jax_model(kind, jseq.SEQ_AXIS if ring else None),
                 skip_layers=[], **COMMON, **knobs)
    # Registration traces the non-ring twin: the ring's collectives need
    # the mesh.
    kw = {**({'train': False} if lm else {}),
          **({'init_model': _jax_model(kind)} if ring else {})}
    jax.eval_shape(lambda k, v: kfac.init(k, v, **kw),
                   jax.random.PRNGKey(0), jnp.asarray(x))
    method = JCommMethod[comm.upper().replace('-', '_')]
    mesh = JD.make_kfac_mesh(devices=jax.devices()[:WORLD],
                             comm_method=method, grad_worker_fraction=frac,
                             seq_parallel=seq_parallel)
    dk = JD.DistributedKFAC(kfac, mesh, flax_params)
    kstate = dk.init_state(flax_params)

    def loss_fn(out, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            out, batch[1]).mean()

    def model_kwargs_fn(batch):
        kwargs = {'train': False}
        if ring:
            kwargs['pos_offset'] = (jax.lax.axis_index(jseq.SEQ_AXIS)
                                    * (x.shape[1] // seq_parallel))
        return kwargs

    tx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(lambda g: -LR * g, u), u))
    spec = P(JD.KFAC_AXES, jseq.SEQ_AXIS)
    step = dk.build_train_step(
        loss_fn, tx, donate=False,
        model_kwargs_fn=model_kwargs_fn if lm else None,
        **({'batch_spec': (spec, spec)} if ring else {}))
    params = jax.tree.map(jnp.asarray, flax_params)
    opt_state = tx.init(params)
    batch = (jnp.asarray(x), jnp.asarray(y))
    rec, extra = {}, {}
    for i in range(STEPS):
        params, opt_state, kstate, extra, _ = step(
            params, opt_state, kstate, extra, batch,
            {'lr': LR, 'damping': COMMON['damping']})
        factors = convert.jax_factors_to_torch(
            jax.tree.map(np.asarray, kstate['factors']), specs)
        for n, f in factors.items():
            for side, t in f.items():
                rec[f's{i}/factor/{n}/{side}'] = t.numpy()
        for n, t in kstate['diag_inv'].items():
            rec[f's{i}/diag_inv/{n.replace("/", ".")}'] = np.asarray(t)
        for n, t in convert.flax_to_torch(
                jax.tree.map(np.asarray, opt_state)).items():
            rec[f's{i}/precond/{n}'] = t.numpy()
    for n, t in convert.flax_to_torch(
            jax.tree.map(np.asarray, params)).items():
        rec[f'param/{n}'] = t.numpy()
    return rec, kfac.approx_summary()


# ---------------------------------------------------------------------------
# The fixture: the world runs while the references are computed here
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from distributed_kfac_pytorch_tpu_torch import convert

    tmp = tmp_path_factory.mktemp('kfac_lm_world')
    rng = np.random.default_rng(0)
    inputs = {
        'embed': (rng.integers(0, EMBED_VOCAB, (EMBED_BATCH, EMBED_IDS)),
                  rng.integers(0, EMBED_CLASSES, EMBED_BATCH)),
        'lm': (rng.integers(0, LM_VOCAB, (LM_BATCH, LM_SEQ)),
               rng.integers(0, LM_VOCAB, (LM_BATCH, LM_SEQ)))}
    flax_params, arrays = {}, {}
    for kind, (x, y) in inputs.items():
        x, y = x.astype(np.int32), y.astype(np.int32)
        kwargs = {'train': False} if kind == 'lm' else {}
        variables = _jax_model(kind).init(jax.random.PRNGKey(0),
                                          jnp.asarray(x), **kwargs)
        flax_params[kind] = jax.tree.map(np.asarray, variables['params'])
        arrays.update({f'{kind}/x': x, f'{kind}/y': y})
        arrays.update({f'{kind}/p/{k}': v.numpy() for k, v in
                       convert.flax_to_torch(flax_params[kind]).items()})
    data = tmp / 'data.npz'
    np.savez(data, **arrays)
    procs = _start_world(tmp, WORLD, CASE_IDS, data,
                         module='test_torch_distributed_lm')
    try:
        loaded = np.load(data)
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        port = {name: port_reference(name, loaded) for name in CASE_IDS}
        torch.set_num_threads(prev)
        ref = {}
        for name in CASE_IDS:
            kind = _case(name)[1]
            params, _, _ = _inputs(kind, loaded)
            specs = KFAC(_model(kind, params), device='cpu').specs
            ref[name] = jax_reference(name, flax_params[kind],
                                      *inputs[kind], specs)
    finally:
        ranks = _finish_world(procs, tmp, WORLD)
    dist = {name: [{k.split('|', 1)[1]: v for k, v in r.items()
                    if k.startswith(name + '|')} for r in ranks]
            for name in CASE_IDS}
    leaked = sum(int(r['jax_modules']) for r in ranks)
    return {'dist': dist, 'port': port, 'jax': ref, 'leaked': leaked}


def _check_steps(got: dict, want: dict, what: str):
    """``_check`` per step, with the factor contributions and the diagonal
    inverses at the factors' tolerance."""
    for step in range(STEPS):
        pre = f's{step}/'
        mine = {k[len(pre):]: v for k, v in got.items() if k.startswith(pre)}
        ref = {k[len(pre):]: v for k, v in want.items() if k.startswith(pre)}
        assert ref and set(ref) <= set(mine), (what, step)
        _check(mine, ref, f'{what} step {step}')
        for key in ref:
            if key.startswith(('diag_inv/', 'contrib/')):
                assert _rel(mine[key], ref[key]) <= 1e-5, (what, step, key)
    _check(got, {k: v for k, v in want.items() if k.startswith('param/')},
           what)


def test_children_never_import_jax(runs):
    assert runs['leaked'] == 0


@pytest.mark.parametrize('name', CASE_IDS)
def test_grid_and_resolved_approx(runs, name):
    rec = runs['dist'][name][0]
    assert tuple(rec['grid']) == _case(name)[4]
    want = {k.replace('/', '.'): v
            for k, v in runs['jax'][name][1].items()}
    assert json.loads(str(rec['approx'])) == want


@pytest.mark.parametrize('name', CASE_IDS)
def test_ranks_agree_exactly(runs, name):
    first, *rest = runs['dist'][name]
    for r, rec in enumerate(rest, start=1):
        assert set(rec) == set(first)
        for key in first:
            np.testing.assert_array_equal(rec[key], first[key],
                                          err_msg=f'rank {r} {key}')


@pytest.mark.parametrize('name', CASE_IDS)
def test_matches_single_device_kfac(runs, name):
    got, want = runs['dist'][name][0], runs['port'][name]
    _check_steps(got, want, 'single-device KFAC')
    for step in range(STEPS):
        nu, nu_ref = float(got[f's{step}/nu']), float(want[f's{step}/nu'])
        assert abs(nu - nu_ref) <= 1e-5 * abs(nu_ref), step


@pytest.mark.parametrize('name', CASE_IDS)
def test_matches_jax_distributed(runs, name):
    _check_steps(runs['dist'][name][0], runs['jax'][name][0],
                 'JAX DistributedKFAC')


@pytest.mark.parametrize('name', [c[0] for c in CASES
                                  if c[5].get('eigh_method') == 'xla'])
def test_checkpoint_round_trip(runs, name):
    """Saved row stacks and diagonal inverses load back exactly; on
    another row's stacks every rank rebuilds both, to the firing's
    values."""
    for r, rec in enumerate(runs['dist'][name]):
        assert bool(rec['reload_same']), r
        assert float(rec['reload_err']) == 0.0, r
        assert float(rec['rebuilt_err']) == 0.0, r


# ---------------------------------------------------------------------------
# The LM CLI in two torchrun-style processes
# ---------------------------------------------------------------------------

CLI_CASES = {
    'lstm': {'arch': 'lstm', 'emsize': 12, 'nhid': 12,
             'comm_method': 'hybrid-opt', 'grad_worker_fraction': 0.5},
    'transformer_tied_reduce': {'arch': 'transformer', 'emsize': 16,
                                'nheads': 2, 'nlayers': 1, 'tied': True,
                                'kfac_approx': 'reduce',
                                'comm_method': 'mem-opt'},
}


@pytest.mark.parametrize('name', list(CLI_CASES))
def test_cli_two_ranks_torchrun_style(name):
    """``train_language_model.train(..., device='cpu')`` in two processes
    with torchrun's environment: ``DistributedKFAC`` (grid 2 x 1), both
    ranks' losses and validation loss equal and finite."""
    cfg = {'synthetic_vocab': 40, 'synthetic_size': 2000, 'bptt': 8,
           'batch_size': 4, 'epochs': 1, 'max_steps': 3,
           'kfac_update_freq': 2, 'quiet': True, **CLI_CASES[name]}
    code = (
        'import json, torch\n'
        'import torch.distributed as dist\n'
        'torch.set_num_threads(1)\n'
        'from distributed_kfac_pytorch_tpu_torch import '
        'train_language_model as T\n'
        f'r = T.train({cfg!r}, device="cpu")\n'
        "k = r['state'].kfac\n"
        "print('RESULT', json.dumps({'losses': r['losses'], 'val': "
        "r['val']['loss'], 'kind': type(k).__name__, 'grid': "
        "[k.n_rows, k.n_cols], 'approx': k.kfac.approx_summary(), "
        "'world': dist.get_world_size()}))\n")
    results = run_two_ranks(code)
    assert results[0] == results[1]
    res = results[0]
    assert res['kind'] == 'DistributedKFAC' and res['grid'] == [2, 1]
    assert res['world'] == 2
    assert len(res['losses']) == 3
    assert all(np.isfinite(res['losses'])) and np.isfinite(res['val'])
    if CLI_CASES[name].get('kfac_approx') == 'reduce':
        assert res['approx']['embed'] == 'expand+tied'
        assert res['approx']['block0.attn.q_proj'] == 'reduce'


def test_cli_distribution_flags_match_jax():
    """The LM CLI's distribution flags and defaults are the JAX LM CLI's
    (``--warmup-epochs`` 1, not the image CLIs' 5), and the port adds no
    flag the JAX CLI lacks beyond its port-only ones."""
    import importlib.util

    from distributed_kfac_pytorch_tpu_torch import train_language_model
    spec = importlib.util.spec_from_file_location(
        'jax_lm_cli', HERE.parent / 'examples' / 'train_language_model.py')
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    want = vars(jcli.parse_args([]))
    got = vars(train_language_model.build_parser().parse_args([]))
    port_only = {'device', 'synthetic_size', 'synthetic_vocab',
                 'fixed_batch', 'max_steps', 'time_steps', 'quiet',
                 'dist_backend', 'deterministic', 'launch_counts'}
    assert set(got) - port_only <= set(want), set(got) - set(want)
    for key in ('warmup_epochs', 'comm_method', 'grad_worker_fraction',
                'symmetry_aware_comm', 'num_slices', 'fp16',
                'seq_parallel', 'attn_block_size'):
        assert got[key] == want[key], key
    assert got['warmup_epochs'] == 1
    # --num-slices is ported: one process cannot hold two slices.
    with pytest.raises(ValueError, match='does not divide world size 1'):
        train_language_model.train({'num_slices': 2}, device='cpu')
    assert not hasattr(engine, 'UNPORTED_FLAGS')
