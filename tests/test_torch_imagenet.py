"""ImageNet ResNet slice of the torch port against the JAX package: the
model's train-mode forward through ``convert.py``, the registered layers
and factor dims of the full ResNet-50, the label-smoothed loss and the
synthetic ImageNet arrays. Inputs are numpy arrays from a seed."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.models import imagenet_resnet as jres
from distributed_kfac_pytorch_tpu.training import datasets as jdata
from distributed_kfac_pytorch_tpu.training import utils as jutils
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch import layers as L
from distributed_kfac_pytorch_tpu_torch.models import imagenet_resnet
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC, \
    eigen_family
from distributed_kfac_pytorch_tpu_torch.training import datasets, utils


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize('bottleneck', [True, False],
                         ids=['bottleneck', 'basic'])
def test_train_forward_logits_and_loss(bottleneck):
    # Logits relative to the largest one. The port is held at 1e-5 to its
    # own float64 forward; against flax at 3e-5, because the flax fp32
    # forward is itself ~1e-5 to 2.5e-5 from that float64 forward at these
    # sizes (train-mode BatchNorm over 4 to 64 values per channel, taps
    # summed in another order), against ~2e-6 for the port. Loss: rel 1e-5.
    fmodel = jres.ImageNetResNet(stage_sizes=(1, 1, 1, 1),
                                 bottleneck=bottleneck, num_classes=10,
                                 width=8)
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(
        'float32')
    labels = np.arange(4) % 10
    variables = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, _ = fmodel.apply(variables, jnp.asarray(x), train=True,
                          mutable=['batch_stats'])
    ref_loss = jutils.label_smooth_loss(ref, jnp.asarray(labels), 0.1)
    model = imagenet_resnet.ImageNetResNet((1, 1, 1, 1),
                                           bottleneck=bottleneck,
                                           num_classes=10, width=8)
    sd = convert.flax_to_torch(variables['params'],
                               variables['batch_stats'])
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    out = model.train()(xt)
    loss = utils.label_smooth_loss(out, torch.from_numpy(labels), 0.1)
    got, ref = out.detach().numpy(), np.asarray(ref)
    assert np.abs(got - ref).max() <= 3e-5 * np.abs(ref).max()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    with torch.no_grad():
        exact = model.double()(xt.double()).numpy()
    assert np.abs(got - exact).max() <= 1e-5 * np.abs(exact).max()
    # The converted tree maps back to the flax tree unchanged.
    params, stats = convert.torch_to_flax(sd)
    for a, b in ((variables['params'], params),
                 (variables['batch_stats'], stats)):
        ra = jax.tree_util.tree_leaves_with_path(a)
        rb = jax.tree_util.tree_leaves_with_path(b)
        assert [p for p, _ in ra] == [p for p, _ in rb]
        for (_, u), (_, v) in zip(ra, rb):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.fixture(scope='module')
def resnet50():
    """The port's ResNet-50 and the JAX KFAC state's shapes over
    ``jax.eval_shape`` (no compute), under the default 'auto' dispatch."""
    jkfac = JKFAC(jres.get_model('resnet50'))
    _, jstate = jax.eval_shape(jkfac.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 64, 64, 3)))
    model = imagenet_resnet.get_model('resnet50')
    return model, KFAC(model, device='cpu'), jstate


def test_resnet50_tree_round_trips_through_convert(resnet50):
    # The flax ResNet-50 variables (as zeros of their eval_shape shapes)
    # map onto the port's state_dict key for key and shape, and back.
    model = resnet50[0]
    shapes = jax.eval_shape(jres.get_model('resnet50').init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = convert.flax_to_torch(zeros['params'], zeros['batch_stats'])
    ref = model.state_dict()
    assert set(sd) == set(ref)
    for key, t in ref.items():
        assert tuple(sd[key].shape) == tuple(t.shape), key
    params, stats = convert.torch_to_flax(sd)
    for tree, back in ((zeros['params'], params),
                       (zeros['batch_stats'], stats)):
        assert jax.tree.structure(tree) == jax.tree.structure(back)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            assert a.shape == b.shape


def test_resnet50_parameter_count(resnet50):
    model, _, _ = resnet50
    assert sum(p.numel() for p in model.parameters()) == 25_557_032


def test_resnet50_layers_and_factor_dims_match_jax(resnet50):
    model, kfac, jstate = resnet50
    params = dict(model.named_parameters())
    dims = {name: L.factor_shapes(spec, kfac._layer_params(name, params))
            for name, spec in kfac.specs.items()}
    ref = {name.replace('/', '.'): (f['A'].shape[0], f['G'].shape[0])
           for name, f in jstate['factors'].items()}
    assert len(dims) == 54
    assert dims == ref
    counts = collections.Counter(d for pair in dims.values() for d in pair)
    assert sorted(counts.items()) == [
        (64, 12), (128, 12), (147, 1), (256, 26), (512, 19), (576, 3),
        (1000, 1), (1024, 14), (1152, 4), (2048, 6), (2049, 1), (2304, 6),
        (4608, 3)]


def test_resnet50_auto_inverse_slots_match_jax(resnet50):
    # The 'auto' layout at full width, without allocating it: eigen slots
    # for dims <= 640, baked slots above, both kinds on the 31 mixed
    # layers.
    model, kfac, jstate = resnet50
    params = dict(model.named_parameters())
    mixed = 0
    for name, spec in kfac.specs.items():
        a, g = L.factor_shapes(spec, kfac._layer_params(name, params))
        methods = dict(zip('AG', kfac._side_methods(a, g, name)))
        is_mixed = eigen_family(methods['A']) != eigen_family(methods['G'])
        mixed += is_mixed
        keys = set()
        for side, method in methods.items():
            if eigen_family(method):
                keys |= {f'Q{side}', f'd{side}'}
            if is_mixed or not eigen_family(method):
                keys.add(f'{side}_inv')
        assert keys == set(jstate['inverses'][name.replace('.', '/')]), name
    assert mixed == 31


@pytest.mark.parametrize('smoothing', [0.0, 0.1])
def test_label_smooth_loss_matches_jax(smoothing):
    # rel 1e-6: one fp32 log-softmax over 1000 classes.
    rng = np.random.default_rng(5)
    logits = rng.normal(scale=3.0, size=(16, 1000)).astype('float32')
    labels = rng.integers(0, 1000, size=16)
    ref = jutils.label_smooth_loss(jnp.asarray(logits), jnp.asarray(labels),
                                   smoothing)
    got = utils.label_smooth_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_synthetic_imagenet_equals_jax():
    (tx, ty), (vx, vy) = datasets.get_imagenet(image_size=32,
                                               synthetic_size=8)
    (jtx, jty), (jvx, jvy) = jdata.get_imagenet(image_size=32,
                                                synthetic_size=8)
    for got, ref in ((tx, jtx), (vx, jvx)):
        assert got.shape == (8, 3, 32, 32) and got.dtype == np.float32
        np.testing.assert_array_equal(got,
                                      np.asarray(ref).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(ty, jty)
    np.testing.assert_array_equal(vy, jvy)


def test_imagenet_directory_reader_is_not_ported(tmp_path):
    (tmp_path / 'train').mkdir()
    with pytest.raises(NotImplementedError, match='directory reader'):
        datasets.get_imagenet(str(tmp_path))


@pytest.mark.parametrize('kwargs', [{'dtype': torch.bfloat16},
                                    {'dtype': torch.float16,
                                     'remat': True}])
def test_unported_model_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        imagenet_resnet.get_model('resnet18', **kwargs)
