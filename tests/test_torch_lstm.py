"""The LSTM modules and the LSTM language model of the torch port against
the flax ones, on the same numpy inputs and converted parameters
(``convert.flax_to_torch``). Dropout 0; outputs and states within 1e-5
(fp32 forward passes of the same arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu.models import lstm_lm as jlm
from distributed_kfac_pytorch_tpu.modules import lstm as jlstm
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.capture import KFACCapture
from distributed_kfac_pytorch_tpu_torch.models import lstm_lm
from distributed_kfac_pytorch_tpu_torch.modules import lstm

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _load(module: torch.nn.Module, variables) -> torch.nn.Module:
    params = jax.tree.map(np.asarray, variables['params'])
    module.load_state_dict(convert.flax_to_torch(params))
    return module.eval()


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('kfac_cell', [True, False])
def test_cell(kfac_cell):
    x, h, c = _rand(3, 4, seed=1), _rand(3, 5, seed=2), _rand(3, 5, seed=3)
    jcell = (jlstm.LSTMCellKFAC if kfac_cell else jlstm.LSTMCell)(5)
    variables = jcell.init(jax.random.PRNGKey(0), x, (h, c))
    y_j, (h_j, c_j) = jcell.apply(variables, x, (h, c))
    cell = _load((lstm.LSTMCellKFAC if kfac_cell else lstm.LSTMCell)(4, 5),
                 variables)
    names = {n for n, _ in cell.named_modules() if n}
    assert names == ({f'w_{g}{s}' for g in 'ifgo' for s in 'xh'}
                     if kfac_cell else {'w_ih', 'w_hh'})
    y_t, (h_t, c_t) = cell(*map(torch.from_numpy, (x,)),
                           (torch.from_numpy(h), torch.from_numpy(c)))
    for got, ref in ((y_t, y_j), (h_t, h_j), (c_t, c_j)):
        _close(got, ref)


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('masked', [False, True])
def test_layer(reverse, masked):
    xs = _rand(3, 6, 4, seed=4)
    lengths = np.array([6, 4, 1]) if masked else None
    jlayer = jlstm.LSTMLayer(5, kfac_cell=True, reverse=reverse)
    variables = jlayer.init(jax.random.PRNGKey(1), xs, lengths=lengths)
    out_j, (h_j, c_j) = jlayer.apply(variables, xs, lengths=lengths)
    layer = _load(lstm.LSTMLayer(4, 5, kfac_cell=True, reverse=reverse),
                  variables)
    out_t, (h_t, c_t) = layer(
        torch.from_numpy(xs),
        lengths=None if lengths is None else torch.from_numpy(lengths))
    for got, ref in ((out_t, out_j), (h_t, h_j), (c_t, c_j)):
        _close(got, ref)


@pytest.mark.parametrize('kfac_cell', [True, False])
def test_two_layer_bidirectional_lstm(kfac_cell):
    xs = _rand(2, 5, 3, seed=5)
    lengths = np.array([5, 3])
    jmodel = jlstm.LSTM(4, num_layers=2, bidirectional=True,
                        kfac_cell=kfac_cell)
    variables = jmodel.init(jax.random.PRNGKey(2), xs, lengths=lengths,
                            train=False)
    out_j, states_j = jmodel.apply(variables, xs, lengths=lengths,
                                   train=False)
    model = _load(lstm.LSTM(3, 4, num_layers=2, bidirectional=True,
                            kfac_cell=kfac_cell), variables)
    out_t, states_t = model(torch.from_numpy(xs),
                            lengths=torch.from_numpy(lengths))
    assert out_t.shape == (2, 5, 8) and len(states_t) == 4
    _close(out_t, out_j)
    for (h_t, c_t), (h_j, c_j) in zip(states_t, states_j, strict=True):
        _close(h_t, h_j)
        _close(c_t, c_j)


@pytest.mark.parametrize('tied', [False, True])
def test_language_model(tied):
    ids = np.random.default_rng(6).integers(0, 30, size=(3, 7))
    jmodel = jlm.LSTMLanguageModel(vocab_size=30, embedding_dim=8,
                                   hidden_dim=8, num_layers=2, dropout=0.0,
                                   tie_weights=tied)
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(ids),
                            train=False)
    logits_j, states_j = jmodel.apply(variables, jnp.asarray(ids),
                                      train=False)
    model = _load(lstm_lm.LSTMLanguageModel(30, 8, 8, num_layers=2,
                                            dropout=0.0, tie_weights=tied),
                  variables)
    assert hasattr(model, 'decoder') is not tied
    logits_t, states_t = model(torch.from_numpy(ids))
    assert logits_t.shape == (3, 7, 30)
    _close(logits_t, logits_j)
    for (h_t, c_t), (h_j, c_j) in zip(states_t, states_j, strict=True):
        _close(h_t, h_j)
        _close(c_t, c_j)


def test_tied_widths_must_match():
    with pytest.raises(ValueError, match='tie_weights'):
        lstm_lm.LSTMLanguageModel(10, 8, 6, tie_weights=True)


def test_conversion_round_trips_the_lm_tree():
    jmodel = jlm.LSTMLanguageModel(vocab_size=11, embedding_dim=4,
                                   hidden_dim=4, num_layers=2, dropout=0.0)
    variables = jmodel.init(jax.random.PRNGKey(4),
                            jnp.zeros((1, 2), jnp.int32), train=False)
    params = jax.tree.map(np.asarray, variables['params'])
    sd = convert.flax_to_torch(params)
    model = lstm_lm.LSTMLanguageModel(11, 4, 4, num_layers=2, dropout=0.0)
    model.load_state_dict(sd)             # every key, no extras
    assert sd['embed.weight'].shape == (11, 4)
    assert sd['decoder.weight'].shape == (11, 4)
    assert sd['lstm.layer1_d0.cell.w_gh.weight'].shape == (4, 4)
    back, stats = convert.torch_to_flax(model.state_dict(),
                                        embeddings=('embed',))
    assert stats == {}
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in  # noqa: E731
                      jax.tree_util.tree_leaves_with_path(t)}
    ref, got = flat(params), flat(back)
    assert set(ref) == set(got)
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_defaults_init_like_flax():
    # Dense kernels: truncated-normal LeCun (|w| <= 2 std / 0.8796);
    # embedding: normal of std 1/sqrt(dim); biases zero.
    torch.manual_seed(0)
    model = lstm_lm.LSTMLanguageModel(50, 64, 64, num_layers=1)
    w = model.lstm.layer0_d0.cell.w_ix.weight.detach()
    bound = 2.0 / 0.87962566103423978 / 64 ** 0.5
    assert float(w.abs().max()) <= bound + 1e-6
    assert abs(float(w.std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5
    bias = model.lstm.layer0_d0.cell.w_ix.bias.detach()
    assert float(bias.abs().max()) == 0.0
    emb = model.embed.weight.detach()
    assert abs(float(emb.std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5


def test_capture_aligns_calls_over_the_unrolled_loop():
    # 2 layers x 8 gates, each called once per timestep: 35 (a, g) pairs
    # per gate, call t's a is the gate's input at timestep t and its g the
    # gradient of that call's output.
    torch.manual_seed(1)
    model = lstm_lm.LSTMLanguageModel(20, 6, 6, num_layers=2, dropout=0.0)
    cap = KFACCapture(model, skip_layers=['embed', 'decoder'])
    assert len(cap.specs) == 16
    ids = torch.randint(0, 20, (2, 35))
    seen = {}

    def spy(name):
        def hook(mod, inputs, output):
            seen.setdefault(name, []).append(inputs[0].detach())
            output.register_hook(
                lambda g: seen.setdefault(name + '/g', []).insert(0, g))
        return hook

    handles = [dict(model.named_modules())[n].register_forward_hook(spy(n))
               for n in ('lstm.layer0_d0.cell.w_ix',
                         'lstm.layer1_d0.cell.w_oh')]
    loss, out, grads, captures = cap.loss_and_grads(
        lambda out: out[0].square().mean(), ids)
    for h in handles:
        h.remove()
    assert isinstance(out, tuple) and not out[0].requires_grad
    for name in ('lstm.layer0_d0.cell.w_ix', 'lstm.layer1_d0.cell.w_oh'):
        a_calls, g_calls = captures[name]['a'], captures[name]['g']
        assert len(a_calls) == len(g_calls) == 35
        for t in range(35):
            assert torch.equal(a_calls[t], seen[name][t])
            # Backward runs the calls in reverse: the spy prepends.
            assert torch.equal(g_calls[t], seen[name + '/g'][t])
        # The timesteps differ from each other (no call captured twice).
        assert not torch.equal(g_calls[0], g_calls[-1])


def test_unskipped_embedding_raises(tmp_path):
    # Embedding K-FAC is ported: the capture registers the table (a
    # diagonal A over the vocabulary), and the distributed wrapper takes
    # it (the diagonal A's inverse replicated, its G in the buckets).
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    model = lstm_lm.LSTMLanguageModel(20, 6, 6, num_layers=1)
    spec = KFACCapture(model, skip_layers=['decoder']).specs['embed']
    assert (spec.kind, spec.vocab_size) == ('embedding', 20)
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/s',
                            rank=0, world_size=1)
    try:
        dk = DistributedKFAC(KFAC(model, skip_layers=['decoder'],
                                  device='cpu'))
        state = dk.init_state()
        assert torch.equal(state['factors']['embed']['A'], torch.ones(20))
        assert ('embed', 'G') in dk.assignment.buckets[6].slot
        assert all(('embed', 'A') not in plan.slot
                   for plan in dk.assignment.buckets.values())
    finally:
        dist.destroy_process_group()
    model.embed.weight.requires_grad_(False)        # frozen: plain skip
    cap = KFACCapture(model, skip_layers=['decoder'])
    assert 'embed' in cap.skipped_modules
