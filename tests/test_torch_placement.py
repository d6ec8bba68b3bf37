"""Static work placement of the torch port against the JAX package, for
exact equality: the placement helpers, ``WorkerAllocator``, the
grad-worker count of each strategy, the decomposition cost, the
triangle wire format, and ``assign_work`` / the precondition shape groups
on the JAX suite's ``SmallCNN``, on ResNet-32, and on two models with an
embedding (whose diagonal A is no work item): the JAX suite's
``EmbedNet`` and the tiny tied Transformer of ``tests/test_sharing.py``,
for every mesh of ``tests/test_distributed.py`` plus 1 x 1, with
``distribute_layer_factors`` on and off and both assignment strategies.

The golden cases of ``tests/test_placement.py`` also run against the
port's copy: the module is loaded a second time with its placement names
bound to the port's.
"""

import importlib.util
import itertools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu import CommMethod as JCommMethod
from distributed_kfac_pytorch_tpu.models import cifar_resnet as jres
from distributed_kfac_pytorch_tpu.models import transformer_lm as jtl
from distributed_kfac_pytorch_tpu.ops import factors as jfactors
from distributed_kfac_pytorch_tpu.ops import linalg as jlinalg
from distributed_kfac_pytorch_tpu.parallel import distributed as JD
from distributed_kfac_pytorch_tpu.parallel import placement as jplace
from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet, \
    transformer_lm
from distributed_kfac_pytorch_tpu_torch.ops import factors, linalg
from distributed_kfac_pytorch_tpu_torch.parallel import distributed as D
from distributed_kfac_pytorch_tpu_torch.parallel import placement
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC, \
    CommMethod
from test_torch_distributed import SmallCNN, jax_small_cnn
from test_torch_distributed_lm import EmbedNet

HERE = pathlib.Path(__file__).resolve().parent


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        'golden_placement_on_port', HERE / 'test_placement.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ('WorkerAllocator', 'get_block_boundary', 'load_balance',
                 'partition_grad_ranks', 'partition_inv_ranks'):
        setattr(mod, name, getattr(placement, name))
    return mod


_golden = _golden_module()
TestPortGoldenLoadBalance = _golden.TestLoadBalance
TestPortGoldenPartitions = _golden.TestPartitions
TestPortGoldenBlockBoundary = _golden.TestBlockBoundary
TestPortGoldenWorkerAllocator = _golden.TestWorkerAllocator


@pytest.mark.parametrize('seed', range(6))
def test_load_balance_matches(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 9))
        work = [float(w) for w in rng.integers(1, 6, size=rng.integers(1, 30))
                ** 3]
        assert placement.load_balance(n, work) == jplace.load_balance(n, work)


@pytest.mark.parametrize('size', [1, 2, 3, 4, 6, 8, 12, 16])
def test_partitions_and_allocator_match(size):
    for k in range(1, size + 1):
        assert (placement.partition_grad_ranks(size, k)
                == jplace.partition_grad_ranks(size, k))
        assert (placement.partition_inv_ranks(size, k)
                == jplace.partition_inv_ranks(size, k))
    for rows, cols in itertools.product(range(1, size + 1), repeat=2):
        if rows * cols != size:
            continue
        port = placement.WorkerAllocator.from_grid(rows, cols)
        ref = jplace.WorkerAllocator.from_grid(rows, cols)
        assert port == placement.WorkerAllocator(ref.size,
                                                 ref.compute_grad_fraction)
        np.testing.assert_array_equal(port.grid, ref.grid)
        assert port.grid.shape == (rows, cols)
        for attr in ('grad_workers', 'bcast_grad_ranks', 'bcast_inv_ranks',
                     'grad_groups', 'inv_groups'):
            assert getattr(port, attr) == getattr(ref, attr), attr
        for r in range(size):
            assert port.get_grad_ranks(r) == ref.get_grad_ranks(r)
            assert port.get_inv_ranks(r) == ref.get_inv_ranks(r)
            assert port.grad_group_index(r) == ref.grad_group_index(r)
            assert port.inv_group_index(r) == ref.inv_group_index(r)


def test_block_boundary_matches():
    for shape in ([100, 100], [7, 13], [64, 1000]):
        for n in range(1, min(shape) + 1):
            for i in range(n):
                assert (placement.get_block_boundary(i, n, shape)
                        == jplace.get_block_boundary(i, n, shape))
    for bad in ((3, 3, [10, 10]), (0, 11, [10, 10])):
        for fn in (placement.get_block_boundary,
                   jplace.get_block_boundary):
            with pytest.raises(ValueError):
                fn(*bad)


@pytest.mark.parametrize('size', [1, 2, 4, 8, 16])
def test_resolve_grad_workers_matches(size):
    for method, jmethod in zip(CommMethod, JCommMethod):
        assert method.name == jmethod.name
        for frac in (0.0, 0.125, 0.25, 0.5, 1.0, 0.3):
            try:
                want = JD.resolve_grad_workers(size, jmethod, frac)
            except ValueError:
                with pytest.raises(ValueError):
                    D.resolve_grad_workers(size, method, frac)
                continue
            assert D.resolve_grad_workers(size, method, frac) == want


def test_decomposition_cost_matches():
    for dim, count, rank in itertools.product((1, 27, 576, 4608), (1, 3),
                                              (None, 0, 16)):
        assert (linalg.decomposition_cost(dim, count, rank)
                == jlinalg.decomposition_cost(dim, count, rank))


@pytest.mark.parametrize('shape', [(1, 1), (5, 5), (4, 7), (8, 8)])
def test_triu_wire_format_matches(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    if shape[0] == shape[1]:
        x = x + x.T
    got = factors.get_triu(torch.from_numpy(x))
    want = np.asarray(jfactors.get_triu(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        factors.fill_triu(shape, got).numpy(),
        np.asarray(jfactors.fill_triu(shape, jnp.asarray(want))))
    if shape[0] == shape[1]:
        np.testing.assert_array_equal(factors.fill_triu(shape, got).numpy(),
                                      x)


# ---------------------------------------------------------------------------
# assign_work and the precondition groups on two models
# ---------------------------------------------------------------------------

MESHES = [(1, 8), (8, 1), (2, 4), (4, 2), (1, 1)]


def _resnet32_pair():
    jm = jres.get_model('resnet32')
    jk = JKFAC(jm)
    variables, _ = jk.init(jax.random.PRNGKey(0), jnp.ones((2, 32, 32, 3)))
    return (jk, variables['params']), cifar_resnet.get_model('resnet32')


def _cnn_pair():
    jk = JKFAC(jax_small_cnn())
    variables, _ = jk.init(jax.random.PRNGKey(0), jnp.ones((2, 8, 8, 3)))
    return (jk, variables['params']), SmallCNN()


def _embed_pair():
    from test_distributed import EmbedNet as JaxEmbedNet
    jk = JKFAC(JaxEmbedNet())
    variables, _ = jk.init(jax.random.PRNGKey(0), jnp.zeros((2, 6),
                                                            jnp.int32))
    return (jk, variables['params']), EmbedNet()


def _tied_lm_pair():
    """The tiny tied Transformer of ``tests/test_sharing.py`` (vocabulary
    37, d 16, 1 block, 2 heads, sequence 8)."""
    jk = JKFAC(jtl.TransformerLM(vocab_size=37, d_model=16, num_layers=1,
                                 num_heads=2, max_len=8, dropout=0.0,
                                 tie_weights=True), skip_layers=[])
    variables, _ = jk.init(jax.random.PRNGKey(0), jnp.zeros((2, 8),
                                                            jnp.int32),
                           train=False)
    return (jk, variables['params']), transformer_lm.TransformerLM(
        37, d_model=16, num_layers=1, num_heads=2, max_len=8, dropout=0.0,
        tie_weights=True)


_MODELS = {}
_PAIRS = {'cnn': _cnn_pair, 'resnet32': _resnet32_pair,
          'embed': _embed_pair, 'tied_lm': _tied_lm_pair}


def _models(which):
    if which not in _MODELS:
        _MODELS[which] = _PAIRS[which]()
    return _MODELS[which]


@pytest.mark.parametrize('strategy', ['compute', 'memory'])
@pytest.mark.parametrize('distribute', [True, False, None])
@pytest.mark.parametrize('mesh', MESHES, ids=lambda m: f'{m[0]}x{m[1]}')
@pytest.mark.parametrize('which', list(_PAIRS))
def test_assign_work_matches(which, mesh, distribute, strategy):
    (jk, jparams), model = _models(which)
    jk.assignment_strategy = strategy
    kfac = KFAC(model, device='cpu', assignment_strategy=strategy)
    assert [n.replace('/', '.') for n in jk.specs] == list(kfac.specs)
    rows, cols = mesh
    want = JD.assign_work(jk, jparams, rows, cols,
                          distribute_layer_factors=distribute)
    got = D.assign_work(kfac, rows, cols,
                        distribute_layer_factors=distribute)
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
    assert got.layer_row == {n.replace('/', '.'): r
                             for n, r in want.layer_row.items()}
    assert got.diag_layers == tuple(n.replace('/', '.')
                                    for n in want.diag_layers)
    assert set(got.buckets) == set(want.buckets)
    for dim, plan in want.buckets.items():
        mine = got.buckets[dim]
        assert (mine.dim, mine.slots_per_col, mine.n_cols,
                mine.slots_per_row) == (plan.dim, plan.slots_per_col,
                                        plan.n_cols, plan.slots_per_row)
        assert mine.slot == {(n.replace('/', '.'), s): v
                             for (n, s), v in plan.slot.items()}
    # The precondition groups: the JAX method on a stand-in holding what
    # it reads.
    stub = types.SimpleNamespace(
        kfac=jk, assignment=want, total_rows=rows,
        _factor_dims={n: jk_dims for n, jk_dims in (
            (n, D.factor_dims(kfac)[n.replace('/', '.')])
            for n in jk.specs)})
    want_groups = JD.DistributedKFAC._plan_precond_groups(stub)
    got_groups = D.plan_precond_groups(kfac, got)
    assert len(got_groups) == len(want_groups)
    for g, w in zip(got_groups, want_groups):
        assert g['shape'] == w['shape'] and g['S'] == w['S']
        assert g['slot_of'] == {n.replace('/', '.'): v
                                for n, v in w['slot_of'].items()}
        assert g['a_idx'] == w['a_idx'].tolist()
        assert g['g_idx'] == w['g_idx'].tolist()


@pytest.mark.parametrize('mesh', [(4, 1), (4, 2), (8, 1)],
                         ids=lambda m: f'{m[0]}x{m[1]}')
def test_row_holding_only_the_embedding(mesh):
    """On these grids LPT gives ``EmbedNet``'s embedding a row of its own:
    the row's only bucket item is the embedding's G (exact against JAX in
    ``test_assign_work_matches``), and every other layer's A and G lie in
    other rows."""
    _, model = _models('embed')
    got = D.assign_work(KFAC(model, device='cpu'), *mesh)
    row = got.layer_row['embed']
    assert [n for n, r in got.layer_row.items() if r == row] == ['embed']
    assert got.diag_layers == ('embed',)
    in_row = [key for plan in got.buckets.values() for key in plan.slot
              if got.layer_row[key[0]] == row]
    assert in_row == [('embed', 'G')]
