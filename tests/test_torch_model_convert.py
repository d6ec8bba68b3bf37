"""CIFAR ResNet of the torch port against the flax model, through
``convert.py``: same weights, same numpy batch."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu.models import cifar_resnet as jres
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


BLOCKS = (1, 1, 1)


def _flax_model_and_vars(seed=0, batch=4):
    model = jres.CifarResNet(num_blocks=BLOCKS)
    x = np.random.default_rng(seed).normal(
        size=(batch, 8, 8, 3)).astype('float32')
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return model, variables, x


def _torch_model(variables):
    model = cifar_resnet.CifarResNet(BLOCKS)
    sd = convert.flax_to_torch(variables['params'],
                               variables['batch_stats'])
    model.load_state_dict(sd, strict=True)
    return model


def test_round_trip():
    _, variables, _ = _flax_model_and_vars()
    sd = convert.flax_to_torch(variables['params'],
                               variables['batch_stats'])
    params, stats = convert.torch_to_flax(sd)
    for ref, got in ((variables['params'], params),
                     (variables['batch_stats'], stats)):
        flat_r = jax.tree_util.tree_leaves_with_path(ref)
        flat_g = jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in flat_r] == [p for p, _ in flat_g]
        for (_, a), (_, b) in zip(flat_r, flat_g):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_state_dict_covers_every_torch_tensor():
    _, variables, _ = _flax_model_and_vars()
    sd = convert.flax_to_torch(variables['params'],
                               variables['batch_stats'])
    model = cifar_resnet.CifarResNet(BLOCKS)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_train_forward_logits_and_loss():
    # rel 1e-5: fp32 convolutions of the same weights; XLA and torch sum
    # the conv taps in different orders.
    fmodel, variables, x = _flax_model_and_vars(batch=8)
    labels = np.arange(8) % 10
    ref, _ = fmodel.apply(variables, jnp.asarray(x), train=True,
                          mutable=['batch_stats'])
    ref_loss = optax.softmax_cross_entropy_with_integer_labels(
        ref, jnp.asarray(labels)).mean()
    model = _torch_model(variables).train()
    out = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    loss = F.cross_entropy(out, torch.from_numpy(labels))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)


def test_eval_forward_matches_with_converted_stats():
    fmodel, variables, x = _flax_model_and_vars(batch=4)
    ref = fmodel.apply(variables, jnp.asarray(x), train=False)
    model = _torch_model(variables).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_running_variance_convention_differs_by_bessel():
    # Pinned difference: one train-mode pass from the same running stats
    # moves flax's var toward the BIASED batch variance and torch's
    # toward the UNBIASED one (momentum 0.1 both):
    #   torch - flax = 0.1 * batch_var * (n/(n-1) - 1), n = B*H*W.
    fmodel, variables, x = _flax_model_and_vars(batch=4)
    _, upd = fmodel.apply(variables, jnp.asarray(x), train=True,
                          mutable=['batch_stats'])
    model = _torch_model(variables).train()
    with torch.no_grad():
        model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    flax_var = np.asarray(upd['batch_stats']['bn1']['var'])
    torch_var = model.bn1.running_var.numpy()
    old = np.asarray(variables['batch_stats']['bn1']['var'])
    n = 4 * 8 * 8
    batch_var = (flax_var - 0.9 * old) / 0.1
    np.testing.assert_allclose(torch_var - flax_var,
                               0.1 * batch_var / (n - 1), rtol=1e-3,
                               atol=1e-6)
    assert np.all(torch_var > flax_var)


@pytest.mark.parametrize('depth', [20, 32])
def test_layer_dims_match_flax(depth):
    # Same registered layers, same factor dims: 6n+1 convs + 1 linear.
    model = cifar_resnet.get_model(f'resnet{depth}')
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == depth - 1
    fmodel = jres.get_model(f'resnet{depth}')
    shapes = jax.eval_shape(fmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))['params']
    sd = model.state_dict()
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [p.key for p in path]
        if keys[-1] != 'kernel':
            continue
        w = sd['.'.join(keys[:-1]) + '.weight']
        assert int(np.prod(w.shape)) == int(np.prod(leaf.shape))
