"""The weight-sharing approximation policy of the torch port
(``sharing.approx``) and its reduced factors against the JAX package.

``resolve_approx`` must give the JAX map exactly on the same spec sets,
and raise the same error (type and message) for the same bad settings;
``is_patch_conv`` must agree on the same conv geometries. The reduced
factors (Linear A / G over 3-D and 4-D inputs, with and without bias; the
patch-embedding conv, whose A the port keeps in its ``(c, kh, kw)``
basis) are held at 1e-6 of the largest reference entry, from numpy
inputs. ``KFAC``'s ``tied_embeddings`` default follows the JAX rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.capture import LayerSpec as JSpec
from distributed_kfac_pytorch_tpu.ops import factors as JF
from distributed_kfac_pytorch_tpu.sharing import approx as japprox
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.capture import LayerSpec
from distributed_kfac_pytorch_tpu_torch.models import transformer_lm
from distributed_kfac_pytorch_tpu_torch.ops import factors as F
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
from distributed_kfac_pytorch_tpu_torch.sharing import approx


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))
                 / max(float(np.max(np.abs(ref))), 1e-30))


# (name, kind, fields) of one spec set; the padding is given per side.
LAYERS = [
    ('embed', 'embedding', dict(vocab_size=100)),
    ('block0/attn/q_proj', 'linear', dict(shared_positions=8)),
    ('block0/attn/out_proj', 'linear', dict(shared_positions=8)),
    ('block0/mlp_in', 'linear', dict(shared_positions=8)),
    ('head', 'linear', dict(shared_positions=1)),
    ('patch_embed', 'conv2d', dict(kernel_size=(4, 4), strides=(4, 4),
                                   padding='VALID')),
    ('stem', 'conv2d', dict(kernel_size=(3, 3), strides=(1, 1),
                            padding=((1, 1), (1, 1)))),
    ('patch_zero', 'conv2d', dict(kernel_size=(2, 2), strides=(2, 2),
                                  padding=((0, 0), (0, 0)))),
]


def _specs(layers=LAYERS):
    jspecs, tspecs = {}, {}
    for name, kind, fields in layers:
        jspecs[name] = JSpec(path=tuple(name.split('/')), kind=kind,
                             has_bias=kind == 'linear', **fields)
        if fields.get('padding') == 'VALID':
            fields = {**fields, 'padding': 'valid'}     # torch's spelling
        tspecs[name] = LayerSpec(path=tuple(name.split('/')), kind=kind,
                                 has_bias=kind == 'linear', **fields)
    return jspecs, tspecs


SETTINGS = [
    None, 'expand', 'reduce',
    {'attn': 'reduce'}, {'q_proj': 'reduce', 'mlp_in': 'expand'},
    {'block0/mlp_in': 'reduce', 'head': 'reduce'},
    {'patch': 'reduce'}, {'embed': 'expand'},
]
BAD_SETTINGS = [
    'kron', 3, ['reduce'], {'attn': 'kron'}, {'nothing': 'reduce'},
    {'embed': 'reduce'}, {'stem': 'reduce'},
]


@pytest.mark.parametrize('setting', SETTINGS, ids=str)
def test_resolve_approx_exact_against_jax(setting):
    jspecs, tspecs = _specs()
    want = japprox.resolve_approx(setting, jspecs)
    assert approx.resolve_approx(setting, tspecs) == want
    assert list(approx.resolve_approx(setting, tspecs)) == list(want)
    annotated = approx.annotate_specs(tspecs, setting)
    jannotated = japprox.annotate_specs(jspecs, setting)
    assert approx.approx_summary(annotated) == japprox.approx_summary(
        jannotated)


@pytest.mark.parametrize('setting', BAD_SETTINGS, ids=str)
def test_resolve_approx_errors_match_jax(setting):
    jspecs, tspecs = _specs()
    with pytest.raises(Exception) as jerr:
        japprox.resolve_approx(setting, jspecs)
    with pytest.raises(Exception) as terr:
        approx.resolve_approx(setting, tspecs)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


def test_patch_conv_and_sharing_predicates():
    jspecs, tspecs = _specs()
    for name in jspecs:
        assert approx.is_patch_conv(tspecs[name]) == \
            japprox.is_patch_conv(jspecs[name]), name
        assert approx.layer_is_shared(tspecs[name]) == \
            japprox.layer_is_shared(jspecs[name]), name


def test_tied_summary_label():
    _, tspecs = _specs([('embed', 'embedding', dict(vocab_size=9,
                                                    tied_calls=1)),
                        ('fc', 'linear', dict(shared_positions=4))])
    assert approx.approx_summary(approx.annotate_specs(tspecs, 'reduce')) \
        == {'embed': 'expand+tied', 'fc': 'reduce'}


@pytest.mark.parametrize('setting', ['expand', 'reduce', None,
                                     {'embed': 'expand'},
                                     {'q_proj': 'reduce'}], ids=str)
def test_tied_embeddings_default_follows_jax(setting):
    class Tiny(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(2)(x)

    kfac = KFAC(transformer_lm.get_model(10, 'tiny', num_layers=1),
                device='cpu', kfac_approx=setting)
    assert kfac.tied_embeddings == JKFAC(
        Tiny(), kfac_approx=setting).tied_embeddings
    assert kfac.kfac_approx == (setting or 'expand')


@pytest.mark.parametrize('setting', ['kron', 7])
def test_kfac_rejects_bad_settings(setting):
    with pytest.raises(ValueError, match='kfac_approx'):
        KFAC(transformer_lm.get_model(10, 'tiny', num_layers=1),
             device='cpu', kfac_approx=setting)


def test_reduce_resolves_from_the_first_capture():
    """Registration runs no forward pass: a Linear's shared positions, and
    with them the automatic 'reduce' map, are read at the first factor
    update."""
    model = transformer_lm.get_model(50, 'tiny', num_layers=1, dropout=0.0)
    kfac = KFAC(model, device='cpu', kfac_approx='reduce')
    assert set(kfac.approx_summary().values()) == {'expand'}
    ids = torch.randint(0, 50, (2, 6))
    _, _, _, caps = kfac.capture.loss_and_grads(
        lambda out: out.square().mean(), ids)
    kfac.update_factors(kfac.init_state(), caps)
    summary = kfac.approx_summary()
    assert summary.pop('embed') == 'expand+tied'
    assert set(summary.values()) == {'reduce'}
    assert kfac.specs['block0.mlp_in'].shared_positions == 6


@pytest.mark.parametrize('has_bias', [True, False])
@pytest.mark.parametrize('shape', [(3, 5, 7), (2, 3, 4, 6), (4, 9)])
def test_linear_reduced_factors(shape, has_bias):
    rng = np.random.default_rng(0)
    a = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    ref_a = JF.linear_a_factor_reduced(jnp.asarray(a), has_bias)
    ref_g = JF.linear_g_factor_reduced(jnp.asarray(g))
    got_a = F.linear_a_factor_reduced(torch.from_numpy(a), has_bias)
    got_g = F.linear_g_factor_reduced(torch.from_numpy(g))
    assert _rel(got_a.numpy(), ref_a) <= 1e-6
    assert _rel(got_g.numpy(), ref_g) <= 1e-6
    if len(shape) == 2:     # no shared axis: reduce equals expand
        assert torch.equal(got_a, F.linear_a_factor(torch.from_numpy(a),
                                                    has_bias))


@pytest.mark.parametrize('has_bias', [True, False])
def test_patch_conv_reduced_factors(has_bias):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 8, 8, 2)).astype(np.float32)       # NHWC
    g = rng.normal(size=(3, 2, 2, 5)).astype(np.float32)       # NHWC
    ref_a = JF.conv2d_a_factor_reduced(jnp.asarray(x), (4, 4), (4, 4),
                                       'VALID', has_bias,
                                       compute_dtype=jnp.float32)
    ref_g = JF.conv2d_g_factor_reduced(jnp.asarray(g))
    got_a = F.conv2d_a_factor_reduced(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), (4, 4), (4, 4),
        ((0, 0), (0, 0)), has_bias)
    got_g = F.conv2d_g_factor_reduced(
        torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    perm = convert.conv_a_perm((4, 4), 2, has_bias)
    ref_a = np.asarray(ref_a)[perm][:, perm]
    assert _rel(got_a.numpy(), ref_a) <= 1e-6
    assert _rel(got_g.numpy(), ref_g) <= 1e-6
