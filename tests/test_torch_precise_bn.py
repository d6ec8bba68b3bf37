"""Precise-BN in the torch port (``engine.precise_bn_recalibrate`` and the
image CLIs' ``--precise-bn-batches``) against the JAX package's
``training.engine.precise_bn_recalibrate``.

Models: the 1-1-1 CIFAR ResNet at 8 px and a narrow ImageNet ResNet-18
(width 8) at 32 px, each with perturbed parameters and running
statistics, three numpy batches of 8. The port keeps torch's unbiased
running variance (the port's slice-1 delta), so its average is of
unbiased per-batch variances: JAX's biased average times ``n / (n - 1)``
with ``n = B*H*W`` values per channel (per rank under a process group).

Tolerances: running means within 1e-5 relative (1e-6 absolute) of
JAX's, running variances within 1e-5 relative of ``n / (n - 1)`` times
JAX's; the training statistics restored bit for bit; a CLI's evaluation statistics within 1e-5 of the
per-batch statistics taken by hand (forward pre-hooks on every
BatchNorm, unbiased variance), relative (1e-6 absolute).
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch import nn

from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet, \
    imagenet_resnet
from distributed_kfac_pytorch_tpu_torch.training import engine

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import test_torch_distributed as tdist  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread per test process (the suite runs files in
    parallel next to JAX's virtual devices)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


B, N_BATCHES = 8, 3
MODELS = {'cifar': 8, 'imagenet': 32}      # model -> image size


def _jax_model(which):
    from distributed_kfac_pytorch_tpu.models import cifar_resnet as jres
    from distributed_kfac_pytorch_tpu.models import imagenet_resnet as jinet
    if which == 'cifar':
        return jres.CifarResNet(num_blocks=(1, 1, 1))
    return jinet.ImageNetResNet(stage_sizes=(2, 2, 2, 2), bottleneck=False,
                                num_classes=10, width=8)


def _port_model(which):
    if which == 'cifar':
        return cifar_resnet.CifarResNet((1, 1, 1))
    return imagenet_resnet.ImageNetResNet((2, 2, 2, 2), bottleneck=False,
                                          num_classes=10, width=8)


def _batches(which):
    rng = np.random.default_rng(1)
    px = MODELS[which]
    return [(rng.normal(size=(B, px, px, 3)).astype('float32'),
             rng.integers(0, 10, size=B)) for _ in range(N_BATCHES)]


def _variables(which):
    """flax variables with every BatchNorm scale, bias and statistic
    perturbed (so neither the initial (1, 0) affine map nor the initial
    (0, 1) statistics hide a fault), as numpy. The kernels keep their
    initialization: perturbed as well, they grow the deep net's
    activations until flax's one-pass variance (``E[x^2] - E[x]^2``)
    cancels away digits the two frameworks then round apart."""
    import jax
    import jax.numpy as jnp
    x = jnp.asarray(_batches(which)[0][0])
    variables = jax.tree.map(np.asarray, _jax_model(which).init(
        jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(2)

    def jitter(path, a):
        if path[-1].key not in ('scale', 'bias', 'mean', 'var'):
            return a
        return (a * (1 + 0.3 * rng.random(a.shape))
                + 0.1 * rng.random(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(jitter, variables)


def _loaded(which, variables):
    model = _port_model(which)
    model.load_state_dict(convert.flax_to_torch(variables['params'],
                                                variables['batch_stats']))
    return model


def _nchw(batches):
    return [(np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y)
            for x, y in batches]


def _jax_recalibrate(which, variables, batches, devices=None):
    import jax
    import jax.numpy as jnp

    from distributed_kfac_pytorch_tpu import CommMethod
    from distributed_kfac_pytorch_tpu.parallel import distributed as JD
    from distributed_kfac_pytorch_tpu.training import engine as jengine
    mesh = (JD.make_kfac_mesh(devices=jax.devices()[:devices],
                              comm_method=CommMethod.COMM_OPT)
            if devices else None)
    out = jengine.precise_bn_recalibrate(
        _jax_model(which), variables['params'],
        {'batch_stats': variables['batch_stats']},
        [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches], mesh)
    return convert.flax_to_torch(
        variables['params'],
        jax.tree.map(np.asarray, out['batch_stats']))


def _values_per_channel(model, x) -> dict:
    """``B*H*W`` of every BatchNorm's input for a batch ``x``."""
    sizes, hooks = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, nn.BatchNorm2d):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, inp, name=name: sizes.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1])))
    with torch.no_grad():
        model.eval()
        model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    return sizes


def _hold_to_jax(got: dict, want: dict, sizes: dict):
    for name, n in sizes.items():
        np.testing.assert_allclose(got[f'{name}.running_mean'].numpy(),
                                   want[f'{name}.running_mean'].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(
            got[f'{name}.running_var'].numpy(),
            want[f'{name}.running_var'].numpy() * n / (n - 1),
            rtol=1e-5, atol=0, err_msg=name)


@pytest.mark.parametrize('which', sorted(MODELS))
def test_recalibrate_matches_jax_times_unbiased_factor(which):
    variables = _variables(which)
    batches = _batches(which)
    want = _jax_recalibrate(which, variables, batches)
    model = _loaded(which, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    momenta = [m.momentum for m in model.modules()
               if isinstance(m, nn.BatchNorm2d)]
    saved = engine.precise_bn_recalibrate(model, _nchw(batches),
                                          device='cpu')
    got = model.state_dict()
    _hold_to_jax(got, want, _values_per_channel(model, _nchw(batches)[0][0]))
    # The returned snapshot is the training state; counters, momenta and
    # the parameters are untouched.
    assert set(saved) == {k for k, _ in model.named_buffers()}
    for k, v in before.items():
        if k.endswith('num_batches_tracked') or not (
                k.endswith('running_mean') or k.endswith('running_var')):
            assert torch.equal(got[k], v), k
        assert torch.equal(saved.get(k, v), v), k
    assert momenta == [m.momentum for m in model.modules()
                       if isinstance(m, nn.BatchNorm2d)]
    engine.restore_buffers(model, saved)
    for k, v in before.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_recalibrate_keeps_the_training_mode_and_records_nothing():
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    model = cifar_resnet.CifarResNet((1, 1, 1))
    kfac = KFAC(model, device='cpu')
    model.eval()
    with kfac.capture.recording():
        engine.precise_bn_recalibrate(model, _nchw(_batches('cifar')),
                                      device='cpu')
    assert not model.training and kfac.capture._a == {}


def test_group_norm_passes_through_unchanged():
    """A model with no BatchNorm: nothing to recalibrate, as in JAX (no
    ``batch_stats`` collection)."""
    import jax
    import jax.numpy as jnp

    from distributed_kfac_pytorch_tpu.models import cifar_resnet as jres
    from distributed_kfac_pytorch_tpu.training import engine as jengine
    model = cifar_resnet.CifarResNet((1, 1, 1), norm='group')
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert engine.precise_bn_recalibrate(
        model, _nchw(_batches('cifar')), device='cpu') == {}
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    jmodel = jres.CifarResNet(num_blocks=(1, 1, 1), norm='group')
    x = jnp.asarray(_batches('cifar')[0][0])
    variables = jmodel.init(jax.random.PRNGKey(0), x)
    extra = {}
    assert jengine.precise_bn_recalibrate(
        jmodel, variables['params'], extra, [(x, None)]) is extra


def test_zero_batches_raise_and_leave_the_statistics():
    model = _loaded('cifar', _variables('cifar'))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match='precise_bn_recalibrate: zero '
                       'batches provided'):
        engine.precise_bn_recalibrate(model, [], device='cpu')
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_cifar_cli_exits_for_a_group_norm_model():
    from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet
    with pytest.raises(SystemExit, match='--precise-bn-batches requires a '
                       "BatchNorm model; 'resnet20gn' has no batch_stats"):
        train_cifar10_resnet.train(
            {'model': 'resnet20gn', 'batch_size': 8, 'synthetic_size': 16,
             'epochs': 1, 'precise_bn_batches': 2, 'quiet': True},
            device='cpu')


def _hand_stats(model, batches) -> dict:
    """The plain average of every BatchNorm's per-batch statistics (mean,
    unbiased variance), taken by forward pre-hooks in training mode."""
    sums, hooks = {}, []

    def hook(mod, inp, name):
        x = inp[0].double()
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=True)
        m, v = sums.get(name, (0.0, 0.0))
        sums[name] = (m + mean, v + var)

    for name, mod in model.named_modules():
        if isinstance(mod, nn.BatchNorm2d):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, inp, name=name: hook(m, inp, name)))
    model.train()
    with torch.no_grad():
        for x, _ in batches:
            model(torch.as_tensor(x))
    for h in hooks:
        h.remove()
    return {name: (m / len(batches), v / len(batches))
            for name, (m, v) in sums.items()}


@pytest.mark.parametrize('cli', ['cifar', 'imagenet'])
def test_cli_evaluates_with_recalibrated_statistics(cli, monkeypatch):
    """``--precise-bn-batches 2`` through a CLI: the evaluation reads the
    average of the statistics of the CLI's batches (CIFAR: the first two
    augmented batches of epoch ``10_000 + epoch``; ImageNet: the first
    two of the epoch's training stream), taken by hand at the evaluated
    weights, and the training statistics come back bit for bit after
    it."""
    import copy

    from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet, \
        train_imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.training import datasets
    seen = {}
    recalibrate, evaluate = (engine.precise_bn_recalibrate,
                             engine.evaluate)

    def spy_recalibrate(model, batches, **kw):
        batches = list(batches)
        seen['batches'] = batches
        seen['model'] = copy.deepcopy(model)
        seen['training'] = {k: v.clone() for k, v in
                            model.state_dict().items()}
        return recalibrate(model, batches, **kw)

    def spy_evaluate(model, batches, **kw):
        seen['eval'] = {k: v.clone() for k, v in model.state_dict().items()}
        return evaluate(model, batches, **kw)

    monkeypatch.setattr(engine, 'precise_bn_recalibrate', spy_recalibrate)
    monkeypatch.setattr(engine, 'evaluate', spy_evaluate)
    if cli == 'cifar':
        # Cholesky inverses for time (the warm polish at 577 takes
        # seconds per CPU firing); the statistics are the BatchNorms'.
        config = {'model': 'resnet20', 'batch_size': 8, 'val_batch_size': 4,
                  'synthetic_size': 32, 'epochs': 1, 'kfac_update_freq': 1,
                  'use_inv_kfac': True, 'precise_bn_batches': 2,
                  'quiet': True, 'seed': 3}
        res = train_cifar10_resnet.train(config, device='cpu')
        (tx, ty), _ = datasets.get_cifar(None, synthetic_size=32)
        stream = datasets.epoch_batches(tx, ty, 8, seed=3, epoch=10_000,
                                        augment=True)
    else:
        # Stages 3-4 (factor dims up to 4608) stay out of K-FAC for time:
        # the statistics under test are the BatchNorms' of every stage.
        config = {'model': 'resnet18', 'image_size': 32, 'batch_size': 4,
                  'val_batch_size': 2, 'synthetic_size': 16, 'epochs': 1,
                  'inverse_method': 'cholesky', 'kfac_update_freq': 1,
                  'kfac_cov_update_freq': 1, 'precise_bn_batches': 2,
                  'quiet': True, 'seed': 3,
                  'skip_layers': ['layer3_block0', 'layer3_block1',
                                  'layer4_block0', 'layer4_block1']}
        res = train_imagenet_resnet.train(config, device='cpu')
        (tx, ty), _ = datasets.get_imagenet(None, image_size=32,
                                            synthetic_size=16)
        stream = datasets.epoch_batches(tx, ty, 4, seed=3, epoch=0)
    want = [next(stream) for _ in range(2)]
    for (gx, gy), (wx, wy) in zip(seen['batches'], want):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    hand = _hand_stats(seen['model'], want)
    for name, (mean, var) in hand.items():
        np.testing.assert_allclose(seen['eval'][f'{name}.running_mean'],
                                   mean.float(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(seen['eval'][f'{name}.running_var'],
                                   var.float(), rtol=1e-5, atol=1e-6)
    final = res['state'].model.state_dict()
    for k, v in seen['training'].items():
        assert torch.equal(final[k], v), k


# ---------------------------------------------------------------------------
# Under a process group: two gloo ranks against a two-device JAX mesh
# ---------------------------------------------------------------------------

def worker_main():
    """One rank: each forwards its slice of every batch; the statistics
    are averaged over the world."""
    import torch.distributed as dist

    from distributed_kfac_pytorch_tpu_torch import launch
    cfg = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    meta = launch.initialize_distributed(
        init_method=f'file://{cfg["store"]}', device='cpu',
        timeout=tdist.WORLD_TIMEOUT / 2)
    data = np.load(cfg['data'])
    model = _port_model('cifar')
    model.load_state_dict({k[3:]: torch.from_numpy(data[k])
                           for k in data.files if k.startswith('sd/')})
    batches = [(data[f'x{i}'], data[f'y{i}']) for i in range(N_BATCHES)]
    engine.precise_bn_recalibrate(model, batches, device='cpu',
                                  distributed=True)
    out = {k: v.numpy().tolist() for k, v in model.state_dict().items()}
    out['jax_modules'] = len([m for m in sys.modules
                              if m.split('.')[0] in ('jax', 'flax')])
    (pathlib.Path(cfg['out'])
     / f'rank{meta["process_index"]}.json').write_text(json.dumps(out))
    dist.destroy_process_group()


def test_two_ranks_average_the_statistics_over_the_world(tmp_path):
    variables = _variables('cifar')
    batches = _nchw(_batches('cifar'))
    sd = convert.flax_to_torch(variables['params'], variables['batch_stats'])
    data = tmp_path / 'data.npz'
    np.savez(data, **{f'sd/{k}': v.numpy() for k, v in sd.items()},
             **{f'x{i}': x for i, (x, _) in enumerate(batches)},
             **{f'y{i}': y for i, (_, y) in enumerate(batches)})
    procs = tdist._start_world(tmp_path, 2, [], data,
                               module='test_torch_precise_bn')
    try:
        want = _jax_recalibrate('cifar', variables, _batches('cifar'),
                                devices=2)
    finally:
        logs = [p.communicate(timeout=tdist.WORLD_TIMEOUT)[0]
                for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    ranks = [json.loads((tmp_path / 'world2' / f'rank{r}.json').read_text())
             for r in range(2)]
    assert ranks[0] == ranks[1] and ranks[0]['jax_modules'] == 0
    got = {k: torch.tensor(v) for k, v in ranks[0].items()
           if k != 'jax_modules'}
    model = _port_model('cifar')
    sizes = _values_per_channel(model, batches[0][0][:B // 2])
    _hold_to_jax(got, want, sizes)
