"""``factor_batch_fraction`` of the torch port against the JAX package, on
the CPU.

  - ``capture.subsample_captures`` keeps the rows JAX's keeps (``ceil(B
    f)`` rows at ``arange(k) B // k``), for every stream (``a``, ``g`` and
    a tied embedding's ``a_tied`` / ``g_tied``), exactly.
  - One factor step of ``KFAC`` at fractions 0.5 and 0.25 from the same
    weights and batch as the JAX ``KFAC``, under ``expand`` (a conv net:
    K2's and K1's plain versions on thinned captures), ``reduce`` and tied
    statistics (the tiny Transformer of ``test_torch_transformer``, batch
    4): every factor within 1e-5 of the largest entry of JAX's; and the
    preconditioned gradients within 1e-4, which read the whole batch's
    gradients.
  - The CLIs pass the fraction through and a run stays finite.

The distributed fraction (each rank thins its own rows) is held to the
single-device port in ``tests/test_torch_overlap.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.capture import \
    subsample_captures as jax_subsample
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cli
from distributed_kfac_pytorch_tpu_torch.capture import subsample_captures
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.training import engine

FACTOR_TOL, PRECOND_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# The rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('fraction', [0.1, 0.25, 0.3, 0.5, 0.75, 0.9, 1.0])
@pytest.mark.parametrize('batch', [1, 2, 5, 8, 16, 17])
def test_subsample_keeps_jax_rows(batch, fraction):
    rng = np.random.default_rng(batch)
    streams = {'a': (rng.normal(size=(batch, 3)).astype(np.float32),
                     rng.normal(size=(batch, 2, 4)).astype(np.float32)),
               'g': (rng.normal(size=(batch, 5)).astype(np.float32),),
               'a_tied': (rng.normal(size=(batch, 4, 3)).astype(np.float32),),
               'g_tied': (rng.normal(size=(batch, 4, 6)).astype(np.float32),)}
    want = jax_subsample({'layer': {k: tuple(jnp.asarray(t) for t in v)
                                    for k, v in streams.items()}}, fraction)
    got = subsample_captures({'layer': {k: tuple(torch.from_numpy(t)
                                                 for t in v)
                                        for k, v in streams.items()}},
                             fraction)
    for key, calls in want['layer'].items():
        assert len(got['layer'][key]) == len(calls)
        for g, w in zip(got['layer'][key], calls):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kept = got['layer']['g'][0].shape[0]
    assert kept == max(1, min(batch, math.ceil(batch * fraction)))


def test_full_fraction_is_the_captures_themselves():
    caps = {'layer': {'a': (torch.ones(4, 2),), 'g': (torch.ones(4, 3),)}}
    assert subsample_captures(caps, 1.0) is caps


def test_fraction_validation():
    from test_torch_overlap import MLP
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match='must be in'):
            KFAC(MLP(), device='cpu', factor_batch_fraction=bad)


# ---------------------------------------------------------------------------
# Factors at a fraction, against the JAX KFAC
# ---------------------------------------------------------------------------

LM_BATCH = 4


def _cnn_step(fraction):
    """One step of the conv net of ``test_torch_distributed`` (expand)."""
    from test_torch_distributed import SmallCNN, jax_small_cnn
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 3, 8, 8)).astype(np.float32)
    y = rng.integers(0, 10, size=16)
    x_nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    knobs = dict(factor_update_freq=1, inv_update_freq=1, damping=0.003,
                 lr=0.1, kl_clip=0.001, inverse_method='cholesky',
                 factor_batch_fraction=fraction)
    jk = JKFAC(jax_small_cnn(), **knobs)
    variables, jstate = jk.init(jax.random.PRNGKey(0), jnp.asarray(x_nhwc))
    params = variables['params']
    _, _, jg, jc, _ = jk.capture.loss_and_grads(
        lambda out: optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(y)).mean(), params, jnp.asarray(x_nhwc))
    model = SmallCNN()
    model.load_state_dict(convert.flax_to_torch(
        jax.tree.map(np.asarray, params)))
    tk = KFAC(model, device='cpu', **knobs)
    yt = torch.from_numpy(y)
    _, _, tg, tc = tk.capture.loss_and_grads(
        lambda out: F.cross_entropy(out, yt), torch.from_numpy(x))
    return jk, jstate, jg, jc, tk, tg, tc


def _lm_step(fraction, approx, tied):
    """One step of the tiny Transformer of ``test_torch_transformer``."""
    from test_torch_transformer import (HYPER, SEQ, VOCAB, _jax_model,
                                        _torch_model, _xent)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, VOCAB, size=(LM_BATCH, SEQ)).astype(np.int32)
    targets = rng.integers(0, VOCAB, size=(LM_BATCH, SEQ)).astype(np.int32)
    knobs = dict(HYPER, inverse_method='cholesky', kfac_approx=approx,
                 factor_batch_fraction=fraction)
    jk = JKFAC(_jax_model(tied), skip_layers=[], **knobs)
    variables, jstate = jk.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                train=False)
    params = variables['params']
    _, _, jg, jc, _ = jk.capture.loss_and_grads(
        lambda out: _xent(out, jnp.asarray(targets)), params,
        jnp.asarray(ids), train=False)
    tk = KFAC(_torch_model(jax.tree.map(np.asarray, params), tied),
              device='cpu', **knobs)
    tt = torch.from_numpy(targets).long()
    _, _, tg, tc = tk.capture.loss_and_grads(
        lambda out: engine.lm_loss(out, tt), torch.from_numpy(ids).long())
    return jk, jstate, jg, jc, tk, tg, tc


CASES = {
    'cnn_expand': lambda f: _cnn_step(f),
    'lm_expand_untied': lambda f: _lm_step(f, 'expand', False),
    'lm_reduce_tied': lambda f: _lm_step(f, 'reduce', True),
    'lm_reduce_untied': lambda f: _lm_step(f, 'reduce', False),
}


@pytest.mark.parametrize('fraction', [0.5, 0.25])
@pytest.mark.parametrize('case', list(CASES))
def test_factor_step_at_a_fraction_matches_jax(case, fraction):
    jk, jstate, jg, jc, tk, tg, tc = CASES[case](fraction)
    jp, jstate = jk.step(jstate, jg, jc, factor_update=True,
                         inv_update=True)
    tp, tstate = tk.step(tk.init_state(), tg, tc, factor_update=True,
                         inv_update=True)
    want = convert.jax_factors_to_torch(
        jax.tree.map(np.asarray, jstate['factors']), tk.specs)
    assert set(want) == set(tstate['factors'])
    for name, f in want.items():
        for side, t in f.items():
            assert _rel(tstate['factors'][name][side], t) <= FACTOR_TOL, (
                name, side)
    tk.factor_batch_fraction = 1.0
    full = tk.step(tk.init_state(), tg, tc, factor_update=True,
                   inv_update=True)[1]
    assert any(not torch.equal(full['factors'][n][s], t)
               for n, f in tstate['factors'].items() for s, t in f.items())
    jpt = convert.flax_to_torch(jax.tree.map(np.asarray, jp))
    for name, t in jpt.items():
        assert _rel(tp[name].detach(), t) <= PRECOND_TOL, name


@pytest.mark.parametrize('fraction', [0.5, 0.25])
def test_cli_at_a_fraction(fraction):
    res = cli.train({'model': 'resnet20', 'batch_size': 8,
                     'val_batch_size': 4, 'synthetic_size': 16, 'epochs': 1,
                     'no_augment': True, 'kfac_update_freq': 1,
                     'factor_batch_fraction': fraction, 'quiet': True},
                    device='cpu')
    assert res['state'].kfac.factor_batch_fraction == fraction
    assert all(math.isfinite(v) for v in res['losses'])
