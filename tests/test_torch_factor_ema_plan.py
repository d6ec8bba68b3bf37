"""The plan of the K1 factor-contraction kernel (``factor_ema_plan``).

The CUDA kernel runs only on the card; what decides how it walks its input
-- the row geometry after collapsing strides, the tile, the lower-triangle
tile pairs, the split-K chunks, the staging path and the workspace -- is
Python, checked here on the CPU at every ResNet-32 and ResNet-50 K1 shape
and at edge cases. All checks are exact (integer bookkeeping, or elements
gathered through the plan's addresses compared bit for bit).
"""

import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu_torch.ops import kernels

# (shape, has_bias, channels_last): the K1 inputs of one K-FAC step.
RESNET32 = [((128, 16, 32, 32), False, False), ((128, 32, 16, 16), False,
                                                False),
            ((128, 64, 8, 8), False, False), ((128, 64), True, False),
            ((128, 10), False, False)]
# ResNet-50 at 224 px, batch 64: every conv output-grad shape (the model's
# conv G factors) and the head's A (with bias) and G.
RESNET50 = [((64, c, h, h), False, False) for c, h in (
    (64, 56), (64, 112), (128, 28), (128, 56), (256, 14), (256, 28),
    (256, 56), (512, 7), (512, 14), (512, 28), (1024, 14), (2048, 7))] + [
    ((64, 2048), True, False), ((64, 1000), False, False)]
EDGES = [((1000, 65), True, False), ((37, 5), False, False),
         ((8, 24, 7, 7), False, True), ((16, 136, 12, 1), False, False),
         ((4, 129, 3, 3), False, False), ((1000, 200), True, False),
         ((16, 200, 7, 7), False, False), ((8, 160, 14, 14), False, True),
         ((1, 40, 5, 5), True, False), ((3, 7, 1, 1), True, False)]
CASES = RESNET32 + RESNET50 + EDGES
IDS = [f'{"x".join(map(str, s))}{"+b" if b else ""}{"-cl" if cl else ""}'
       for s, b, cl in CASES]


def _input(shape, channels_last):
    x = torch.empty(shape)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x


def _plan(shape, has_bias, channels_last, **kw):
    x = _input(shape, channels_last)
    return x, kernels.factor_ema_plan(tuple(x.shape), x.stride(), has_bias,
                                      **kw)


@pytest.mark.parametrize('shape,has_bias,channels_last', CASES, ids=IDS)
def test_chunks_cover_rows_once(shape, has_bias, channels_last):
    _, p = _plan(shape, has_bias, channels_last)
    assert p.rows_per_chunk % 32 == 0 and p.rows_per_chunk > 0
    starts = [c * p.rows_per_chunk for c in range(p.chunks)]
    assert all(s % 32 == 0 for s in starts)
    covered = np.zeros(p.rows, dtype=int)
    for s in starts:
        covered[s:min(p.rows, s + p.rows_per_chunk)] += 1
    assert (covered == 1).all()
    assert starts[-1] < p.rows        # no empty chunk


@pytest.mark.parametrize('shape,has_bias,channels_last', CASES, ids=IDS)
def test_pairs_cover_lower_triangle_once(shape, has_bias, channels_last):
    _, p = _plan(shape, has_bias, channels_last)
    assert p.tile in (32, 64, 128)
    assert p.ntiles == -(-p.d_in // p.tile)
    assert p.npairs == p.ntiles * (p.ntiles + 1) // 2
    pairs = [kernels._pair_of(q) for q in range(p.npairs)]
    expected = [(a, b) for a in range(p.ntiles) for b in range(a + 1)]
    assert pairs == expected


def test_pair_closed_form_far_out():
    # The kernel's float32 sqrt estimate is corrected to the exact pair,
    # also where 8p + 1 is not exact in float32 (the finalize's grid).
    for a in list(range(0, 200)) + [1000, 2047, 2048, 4096, 5000]:
        first = a * (a + 1) // 2
        for q in (first, first + a // 2, first + a):
            assert kernels._pair_of(q) == (a, q - first)


def _rule_16b(x):
    """The 16-byte K-major rule, restated: unit-stride rows, groups of four
    rows inside one image, 16-byte aligned starts."""
    if x.ndim == 2:
        return x.stride(0) == 1 and x.stride(1) % 4 == 0
    h, w = x.shape[2:]
    sb, sc, sh, sw = x.stride()
    ss = sw if w > 1 else sh
    return ss == 1 and (h * w) % 4 == 0 and sb % 4 == 0 and sc % 4 == 0


@pytest.mark.parametrize('shape,has_bias,channels_last', CASES, ids=IDS)
def test_16_byte_path_exactly_when_aligned(shape, has_bias, channels_last):
    x, p = _plan(shape, has_bias, channels_last)
    assert p.path in ('kmajor16', 'kmajor4', 'feature4')
    assert (p.path == 'kmajor16') == _rule_16b(x)
    _, unaligned = _plan(shape, has_bias, channels_last, aligned=False)
    assert unaligned.path != 'kmajor16'
    if p.path != 'kmajor16':
        # Feature-contiguous inputs gather along features.
        assert (p.path == 'feature4') == (p.sc == 1 and not (
            (p.sb if p.inner == 1 else p.ss) == 1))


@pytest.mark.parametrize('hw,expect', [(112, True), (56, True), (28, True),
                                       (14, True), (7, False)])
def test_16_byte_path_at_resnet50_grids(hw, expect):
    _, p = _plan((64, 256, hw, hw), False, False)
    assert (p.path == 'kmajor16') is expect
    assert p.path == ('kmajor16' if expect else 'kmajor4')


@pytest.mark.parametrize('shape,has_bias,channels_last', CASES, ids=IDS)
def test_workspace_matches_allocation(shape, has_bias, channels_last):
    _, p = _plan(shape, has_bias, channels_last)
    floats = p.chunks * p.npairs * p.tile * p.tile
    if has_bias:
        floats += p.chunks * p.ntiles * p.tile
    assert p.ws_bytes == 4 * floats
    ws = kernels._plan_workspace(p, 'cpu')
    assert ws.dtype == torch.float32 and ws.numel() * 4 == p.ws_bytes


@pytest.mark.parametrize('shape,has_bias,channels_last', CASES, ids=IDS)
def test_row_geometry_addresses_the_gram_rows(shape, has_bias,
                                              channels_last):
    """Element (r, c) at b*sb + s*ss + c*sc (r = b*inner + s; inner == 1:
    r*sb), read from the flat storage, is the matrix the plain version
    contracts."""
    x = _input(shape, channels_last)
    x.copy_(torch.arange(x.numel(), dtype=torch.float32).reshape(shape))
    p = kernels.factor_ema_plan(tuple(x.shape), x.stride(), has_bias)
    r = np.arange(p.rows)[:, None]
    c = np.arange(p.d_in)[None, :]
    if p.inner == 1:
        off = r * p.sb + c * p.sc
    else:
        off = (r // p.inner) * p.sb + (r % p.inner) * p.ss + c * p.sc
    flat = x.as_strided((x.untyped_storage().nbytes() // 4,), (1,), 0)
    got = flat.numpy()[off]
    assert np.array_equal(got, kernels._gram_rows(x).numpy())


def test_split_fills_the_card_at_resnet50_heavy_shapes():
    # About one or two waves of resident blocks (1 per SM at tile 128).
    for c, hw in ((256, 56), (512, 28), (1024, 14), (2048, 7)):
        _, p = _plan((64, c, hw, hw), False, False)
        blocks = p.npairs * p.chunks
        assert p.tile == 128 and 100 <= blocks <= 4 * 132, (c, blocks)


def test_plan_rejects_uncollapsible_spatial_strides():
    x = torch.empty(2, 3, 4, 6)[:, :, ::2, :]
    with pytest.raises(ValueError, match='collapse'):
        kernels.factor_ema_plan(tuple(x.shape), x.stride(), False)
