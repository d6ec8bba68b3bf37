"""Factor statistics of the torch port against the JAX package.

Same numpy inputs (seeded) go through the JAX function and its port. The
port's conv layout is NCHW with the A basis ``(c, kh, kw)``; the JAX one
NHWC with ``(kh, kw, c)`` -- inputs are transposed and A factors permuted
(``convert.conv_a_perm``) before comparing.

Tolerance: rel 1e-5 (fp32 contractions of O(1) values over <= a few
hundred rows; summation order differs between XLA and torch), with an
absolute floor of 1e-6 for entries near zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu.ops import factors as JF
from distributed_kfac_pytorch_tpu.ops import pallas_kernels as JP
from distributed_kfac_pytorch_tpu_torch import convert
from distributed_kfac_pytorch_tpu_torch.ops import factors as F
from distributed_kfac_pytorch_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel processes next to JAX's
    virtual devices; torch's default of one thread per core would
    oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _rng(seed):
    return np.random.default_rng(seed)


def _nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize('has_bias', [False, True])
def test_linear_a_factor(has_bias):
    x = _rng(0).normal(size=(3, 7, 12)).astype('float32')
    ref = JF.linear_a_factor(jnp.asarray(x), has_bias,
                             compute_dtype=jnp.float32)
    _close(F.linear_a_factor(torch.from_numpy(x), has_bias), ref)


def test_linear_g_factor():
    g = _rng(1).normal(size=(16, 10)).astype('float32')
    _close(F.linear_g_factor(torch.from_numpy(g)),
           JF.linear_g_factor(jnp.asarray(g), compute_dtype=jnp.float32))


def test_get_cov_bf16_multiplicands():
    # bf16-rounded multiplicands, fp32 accumulation: the rounding is the
    # same on both sides, so only the summation order differs.
    a = _rng(2).normal(size=(64, 9)).astype('float32')
    _close(F.get_cov(torch.from_numpy(a), compute_dtype=torch.bfloat16),
           JF.get_cov(jnp.asarray(a), compute_dtype=jnp.bfloat16))


def test_assemble_bias_factor():
    r = _rng(3)
    cov = r.normal(size=(5, 5)).astype('float32')
    col = r.normal(size=(5,)).astype('float32')
    _close(F._assemble_bias_factor(torch.from_numpy(cov),
                                   torch.from_numpy(col), 0.25),
           JF._assemble_bias_factor(jnp.asarray(cov), jnp.asarray(col),
                                    0.25), rtol=0, atol=0)


def test_conv2d_g_factor():
    g = _rng(4).normal(size=(2, 5, 5, 8)).astype('float32')
    _close(F.conv2d_g_factor(_nhwc_to_nchw(g)),
           JF.conv2d_g_factor(jnp.asarray(g), compute_dtype=jnp.float32))


CONV_CASES = {
    # (input NHWC shape, kernel, strides, padding, has_bias)
    'stem_d27': ((2, 8, 8, 3), (3, 3), (1, 1), 1, False),
    'stride2': ((2, 8, 8, 4), (3, 3), (2, 2), 1, False),
    'bias': ((2, 6, 6, 2), (3, 3), (1, 1), 1, True),
    'same_asym_stride2': ((1, 9, 9, 2), (3, 3), (2, 2), 'SAME', True),
    'valid_1x1': ((3, 4, 4, 5), (1, 1), (1, 1), 'VALID', False),
}


@pytest.mark.parametrize('case', list(CONV_CASES), ids=list(CONV_CASES))
def test_conv2d_a_factor_vs_stock(case):
    shape, k, s, pad, bias = CONV_CASES[case]
    x = _rng(5).normal(size=shape).astype('float32')
    ref = np.asarray(JF.conv2d_a_factor(jnp.asarray(x), k, s, pad, bias,
                                        compute_dtype=jnp.float32))
    p = convert.conv_a_perm(k, shape[-1], bias)
    got = F.conv2d_a_factor(_nhwc_to_nchw(x), k, s, pad, bias)
    _close(got, ref[p][:, p])


@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('case', list(CONV_CASES), ids=list(CONV_CASES))
def test_patch_cov_plain_vs_pallas_interpret(case, bf16):
    # K2's plain version against the Pallas kernel run in interpret mode,
    # strict fp32 multiplicands and bf16-rounded ones (both round the
    # same values; fp32 accumulation either way).
    shape, k, s, pad, bias = CONV_CASES[case]
    x = _rng(6).normal(size=shape).astype('float32')
    ref = np.asarray(JP.conv_a_factor_fused(
        jnp.asarray(x), k, s, pad, bias, mult_bf16=bf16,
        block_batch=shape[0], interpret=True))
    p = convert.conv_a_perm(k, shape[-1], bias)
    got = kernels.patch_cov_plain(_nhwc_to_nchw(x), k, s, pad, bias,
                                  bf16=bf16)
    _close(got, ref[p][:, p])


def test_canonical_pad_matches_jax():
    for padding, spatial, stride in (('SAME', (9, 8), (2, 2)),
                                     ('SAME', (7, 7), (1, 1)),
                                     ('VALID', (5, 5), (1, 1)),
                                     (1, (4, 4), (2, 2)),
                                     (((0, 1), (2, 0)), (6, 6), (1, 1))):
        assert F._canonical_pad(padding, (3, 3), spatial, stride) == \
            JP._canonical_pad(padding, (3, 3), spatial, stride)


FACTOR_EMA_CASES = {
    # (x shape, has_bias, scale kind, with old)
    'contraction': ((32, 24), False, None, False),
    'bias_d13': ((16, 12), True, None, False),
    'ema_bias': ((16, 12), True, None, True),
    'ema_plain_d10': ((40, 10), False, None, True),
}


@pytest.mark.parametrize('case', list(FACTOR_EMA_CASES),
                         ids=list(FACTOR_EMA_CASES))
def test_factor_ema_plain_bf16_vs_pallas_interpret(case):
    # bf16-rounded multiplicands (KFAC factor_compute_dtype=bfloat16).
    shape, bias, _, with_old = FACTOR_EMA_CASES[case]
    x = _rng(11).normal(size=shape).astype('float32')
    n = shape[1] + int(bias)
    old = np.eye(n, dtype='float32') * 0.5 if with_old else None
    ref = JP.fused_factor_ema(jnp.asarray(x),
                              None if old is None else jnp.asarray(old),
                              0.9, has_bias=bias,
                              compute_dtype=jnp.bfloat16, interpret=True)
    got = kernels.factor_ema_plain(
        torch.from_numpy(x), None if old is None else torch.from_numpy(old),
        0.9, has_bias=bias, bf16=True)
    _close(got, ref)


@pytest.mark.parametrize('case', list(FACTOR_EMA_CASES),
                         ids=list(FACTOR_EMA_CASES))
def test_factor_ema_plain_vs_pallas_interpret(case):
    shape, bias, _, with_old = FACTOR_EMA_CASES[case]
    r = _rng(7)
    x = r.normal(size=shape).astype('float32')
    n = shape[1] + int(bias)
    old = (np.eye(n, dtype='float32') * 0.5
           + 0.01 * r.normal(size=(n, n)).astype('float32'))
    old = (old + old.T) / 2 if with_old else None
    ref = JP.fused_factor_ema(jnp.asarray(x),
                              None if old is None else jnp.asarray(old),
                              0.9, has_bias=bias, interpret=True)
    got = kernels.factor_ema_plain(
        torch.from_numpy(x), None if old is None else torch.from_numpy(old),
        0.9, has_bias=bias)
    _close(got, ref)
    # ... and against the stock JAX path (factor + EMA blend).
    stock = JF.linear_a_factor(jnp.asarray(x), bias,
                               compute_dtype=jnp.float32)
    if old is not None:
        stock = JF.update_running_avg(stock, jnp.asarray(old), 0.9)
    _close(got, stock)


def test_factor_ema_conv_g_scaling_from_nchw():
    # Conv G through the K1 wrapper, read from the NCHW grad in place.
    g = _rng(8).normal(size=(4, 5, 5, 8)).astype('float32')
    scale = float(4 * 25) * 25 ** 2
    ref = JP.fused_factor_ema(jnp.asarray(g.reshape(-1, 8)), None, 0.0,
                              scale=scale, interpret=True)
    got = kernels.factor_ema(_nhwc_to_nchw(g), None, 0.0, scale=scale)
    _close(got, ref)
    _close(got, JF.conv2d_g_factor(jnp.asarray(g),
                                   compute_dtype=jnp.float32))


@pytest.mark.parametrize('n', [1, 2, 7, 10, 65])
def test_pack_unpack_round_trip_matches_jax(n):
    m = _rng(9).normal(size=(n, n)).astype('float32')
    m = m + m.T
    packed = F.pack_symmetric(torch.from_numpy(m))
    _close(packed, JF.pack_symmetric(jnp.asarray(m)), rtol=0, atol=0)
    _close(F.unpack_symmetric(packed, n), m, rtol=0, atol=0)


def test_wrappers_on_cpu_launch_nothing():
    kernels.reset_launches()
    x = torch.from_numpy(_rng(10).normal(size=(2, 3, 6, 6))
                         .astype('float32'))
    kernels.patch_cov(x, (3, 3), (1, 1), 1, False)
    kernels.factor_ema(x, None, 0.0)
    assert kernels.LAUNCHES == {'factor_ema': 0, 'patch_cov': 0,
                                'bucket_precond': 0, 'ns_inverse': 0,
                                'jacobi_eigh': 0}


def test_unsupported_compute_dtype_raises():
    with pytest.raises(ValueError, match='compute_dtype'):
        F.get_cov(torch.zeros(4, 2), compute_dtype=torch.float16)
