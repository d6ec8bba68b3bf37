"""The three CLIs of the torch port under ``--fp16`` (fp16 model compute,
the dynamic loss scale and the overflow skip) on the CPU, as the JAX
suite drives its CLIs (``tests/test_training.py``'s ImageNet-model skip
and LM CLI tests):

  - each CLI for two steps (the ImageNet CLI with ``vit_cifar``, the CIFAR
    CLI with ResNet-20, the LSTM and the Transformer LMs): finite losses,
    fp32 parameters, the scaler's per-step record (``2**15``, no overflow)
    and its growth counter;
  - under ``KFAC_CHAOS=nan-batch@1`` the image CLIs skip step 1 and end
    with the state a one-step run leaves, bit for bit (parameters,
    momentum, K-FAC state, BatchNorm buffers), with the scale halved and
    ``kfac_state['step']`` advanced; the LM CLI raises the JAX injector's
    ``ValueError`` (its token windows hold no float to poison);
  - a bundle carries the scale: a run of the LSTM LM CLI stopped after its
    step-2 bundle and resumed to step 4 ends with the uninterrupted run's
    scale state, parameters, momentum and K-FAC state bit for bit;
  - the SGD baseline with ``--fp16`` exits as the JAX CLIs do;
  - ``--remat`` under ``--fp16`` through the ImageNet CLI (a width-8
    bottleneck ResNet in place of ``--model``'s): two steps equal to the
    same run without remat bit for bit (losses, parameters, momentum,
    K-FAC state, BatchNorm buffers, scale), the parameters fp32 after the
    steps and no layer's input left behind by a recomputation.

fp16 convolution backward passes are slow on the CPU, so the image CLIs
run at batch 2 (CIFAR) or with the ViT; the ResNet-50 ``--fp16`` path runs
on the card (``chip_smoke.py`` phase 34).
"""

import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet as cli
from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet as inet
from distributed_kfac_pytorch_tpu_torch import train_language_model as lm
from distributed_kfac_pytorch_tpu_torch.models import imagenet_resnet
from test_torch_fp16_dist import _digest


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

INET = {'model': 'vit_cifar', 'image_size': 32, 'batch_size': 4,
        'val_batch_size': 4, 'synthetic_size': 16, 'epochs': 1,
        'max_steps': 2, 'kfac_update_freq': 2, 'kfac_cov_update_freq': 1,
        'quiet': True, 'fp16': True}
CIFAR = {'model': 'resnet20', 'batch_size': 2, 'val_batch_size': 2,
         'synthetic_size': 8, 'epochs': 1, 'no_augment': True,
         'use_inv_kfac': True, 'kfac_update_freq': 2,
         'kfac_cov_update_freq': 1, 'max_steps': 2, 'quiet': True,
         'fp16': True}
LSTM = {'emsize': 8, 'nhid': 8, 'synthetic_vocab': 30,
        'synthetic_size': 1000, 'bptt': 4, 'batch_size': 2, 'max_steps': 2,
        'epochs': 1, 'kfac_update_freq': 1, 'quiet': True, 'fp16': True}
TRANSFORMER = {'arch': 'transformer', 'emsize': 16, 'nheads': 2,
               'nlayers': 1, 'tied': True, 'kfac_approx': 'reduce',
               'synthetic_vocab': 30, 'synthetic_size': 1000, 'bptt': 8,
               'batch_size': 2, 'max_steps': 2, 'epochs': 1,
               'kfac_update_freq': 1, 'quiet': True, 'fp16': True}


def _final(res) -> dict:
    st = res['state']
    return {'params': _digest(dict(st.model.named_parameters())),
            'buffers': _digest(dict(st.model.named_buffers())),
            'momentum': _digest([s.get('momentum_buffer')
                                 for s in st.optimizer.state.values()]),
            'kfac': _digest({k: v for k, v in st.kfac_state.items()
                             if k != 'step'}),
            'scale': _digest(st.loss_scale)}


@pytest.mark.parametrize('module,config', [
    (inet, INET), (cli, CIFAR), (lm, LSTM), (lm, TRANSFORMER)],
    ids=['imagenet', 'cifar', 'lstm', 'transformer'])
def test_cli_fp16_trains_two_steps(module, config):
    res = module.train(config, device='cpu')
    assert len(res['losses']) == 2
    assert all(np.isfinite(v) for v in res['losses'])
    assert [r['overflow'] for r in res['scaler']] == [False, False]
    assert [r['scale'] for r in res['scaler']] == [2.0 ** 15] * 2
    st = res['state']
    assert all(p.dtype == torch.float32 for p in st.model.parameters())
    assert int(st.loss_scale['growth_count']) == 2


@pytest.mark.parametrize('module,config', [(inet, INET), (cli, CIFAR)],
                         ids=['imagenet', 'cifar'])
def test_cli_nan_batch_skips_the_step(module, config, monkeypatch):
    """Under ``nan-batch@1`` a two-step run ends where a one-step run
    ends, bit for bit (parameters, momentum, K-FAC state, BatchNorm
    buffers), except the advanced scale state."""
    one = _final(module.train({**config, 'max_steps': 1}, device='cpu'))
    monkeypatch.setenv('KFAC_CHAOS', 'nan-batch@1')
    res = module.train(config, device='cpu')
    assert [r['overflow'] for r in res['scaler']] == [False, True]
    assert not np.isfinite(res['losses'][1])
    two = _final(res)
    for key in ('params', 'buffers', 'momentum', 'kfac'):
        assert two[key] == one[key], key
    assert float(res['state'].loss_scale['scale']) == 2.0 ** 14
    assert int(res['state'].kfac_state['step']) == 2


def test_lm_cli_nan_batch_raises_as_jax():
    """Token windows hold no float leaf: the JAX injector's ValueError."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('KFAC_CHAOS', 'nan-batch@1')
        with pytest.raises(ValueError, match='no float leaf'):
            lm.train(LSTM, device='cpu')


def test_bundle_carries_the_loss_scale(tmp_path):
    """A run stopped after its step-2 bundle and resumed to step 4 ends as
    the uninterrupted run, the scale state (the growth counter at 4, not
    restarted) and parameters bit for bit (the LSTM LM CLI; the halved
    scale's round trip is the image CLIs' ``nan-batch`` case above plus
    this carry)."""
    base = {**LSTM, 'max_steps': 4, 'synthetic_size': 2000}
    full = _final(lm.train(base, device='cpu'))
    ck = {**base, 'checkpoint_dir': str(tmp_path / 'ck'),
          'checkpoint_steps': 1}
    first = lm.train({**ck, 'max_steps': 2}, device='cpu')
    assert int(first['state'].loss_scale['growth_count']) == 2
    resumed = lm.train(ck, device='cpu')
    assert resumed['steps'] == 4 and len(resumed['losses']) == 2
    assert int(resumed['state'].loss_scale['growth_count']) == 4
    got = _final(resumed)
    for key in ('params', 'momentum', 'kfac', 'scale'):
        assert got[key] == full[key], key


@pytest.mark.parametrize('module,config', [
    (inet, INET), (cli, CIFAR), (lm, LSTM)], ids=['imagenet', 'cifar', 'lm'])
def test_sgd_baseline_with_fp16_exits(module, config):
    with pytest.raises(SystemExit, match='--fp16 requires the K-FAC step'):
        module.train({**config, 'kfac_update_freq': 0}, device='cpu')


def _narrow_resnet(name, num_classes=1000, dtype=torch.float32,
                   bn_momentum=0.9, remat=False):
    """The CLI's ``get_model`` at width 8, stages 1-1-1-1 (fp16
    convolutions are slow on the CPU)."""
    return imagenet_resnet.ImageNetResNet(
        (1, 1, 1, 1), num_classes=num_classes, dtype=dtype, width=8,
        bn_momentum=bn_momentum, remat=remat)


def test_imagenet_cli_fp16_remat_equals_the_plain_run(monkeypatch):
    """The precision hooks put the fp32 parameters back after a
    rematerialized block's recomputation stops early, and the capture
    keeps no input from it: the remat run is the plain run."""
    monkeypatch.setattr(imagenet_resnet, 'get_model', _narrow_resnet)
    cfg = {'model': 'resnet50', 'image_size': 64, 'batch_size': 8,
           'val_batch_size': 8, 'synthetic_size': 16, 'epochs': 1,
           'max_steps': 2, 'inverse_method': 'cholesky',
           'kfac_update_freq': 1, 'kfac_cov_update_freq': 1,
           'quiet': True, 'fp16': True}
    runs = {remat: inet.train({**cfg, 'remat': remat}, device='cpu')
            for remat in (False, True)}
    plain, remat = runs[False], runs[True]
    assert [r['overflow'] for r in remat['scaler']] == [False, False]
    assert remat['losses'] == plain['losses']
    assert _final(remat) == _final(plain)
    model = remat['state'].model
    assert model.remat and plain['state'].model.remat is False
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(not getattr(m, '_fp32_params', {}) for m in model.modules())
    assert remat['state'].kfac.capture._inputs == {}


TINY_LM = {**TRANSFORMER, 'kfac_update_freq': 2, 'max_steps': 3}


@pytest.mark.parametrize('knobs', [
    {'bf16_factors': True, 'bf16_inverses': True, 'bf16_precond': True},
    {'inv_pipeline_chunks': 2},
    {'inv_staleness': 1},
    {'deferred_factor_reduction': True},
    {'factor_batch_fraction': 0.5},
    {'kfac_approx': 'expand'},
    {'attn_block_size': 4},
    {'inverse_method': 'newton'}],
    ids=['bf16-three', 'chunks', 'staleness', 'deferred', 'fraction',
         'expand', 'attn-block', 'newton'])
def test_fp16_composes_with_the_knobs(knobs):
    """``--fp16`` with each K-FAC knob through the Transformer LM CLI:
    three finite steps under the loss scale, none raising."""
    res = lm.train({**TINY_LM, **knobs}, device='cpu')
    assert len(res['losses']) == 3
    assert all(np.isfinite(v) for v in res['losses'])
    assert [r['overflow'] for r in res['scaler']] == [False] * 3


@pytest.mark.parametrize('knobs', [{'precise_bn_batches': 1},
                                   {'grad_accum': 2}],
                         ids=['precise-bn', 'grad-accum'])
def test_fp16_composes_with_the_image_knobs(knobs):
    res = cli.train({**CIFAR, **knobs}, device='cpu')
    assert len(res['losses']) == 2
    assert all(np.isfinite(v) for v in res['losses'])
    assert np.isfinite(res['val']['loss'])
