"""The plan of the K2 patch-covariance kernel (``patch_cov_plan``).

The CUDA kernel runs only on the card; what decides how it walks its input
-- the staging path (the implicit im2col ``patch4``, or K1's row stagings
for 1 x 1 stride-1 unpadded convs), the tile, the lower-triangle tile
pairs, the split-K chunks and the workspace -- is Python, checked here on
the CPU at every ResNet-32 and ResNet-50 conv A shape and at edge cases.
The kernel's address arithmetic (column descriptors with packed tap
shifts, the per-k-tile row decode, the unsigned bounds check that reads a
padding tap as zero) is restated in int32 numpy and must gather exactly
the patch rows of ``extract_conv2d_patches``. All checks are exact.
"""

import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu_torch.ops import kernels

# (shape, kernel, stride, padding, has_bias, channels_last).
RESNET32 = [((128, c, hw, hw), (3, 3), (s, s), 1, False, False)
            for c, hw, s in ((3, 32, 1), (16, 32, 1), (16, 32, 2),
                             (32, 16, 1), (32, 16, 2), (64, 8, 1))]
# ResNet-50 at 224 px, batch 64: every conv input with its kernel and
# stride (torchvision's v1.5: the stride on the 3 x 3 conv).
RESNET50 = [((64, 3, 224, 224), (7, 7), (2, 2), 3, False, False)] + [
    ((64, c, hw, hw), (k, k), (s, s), k // 2, False, False)
    for c, hw, k, s in (
        (64, 56, 1, 1), (64, 56, 3, 1), (128, 28, 1, 1), (128, 28, 3, 1),
        (128, 56, 3, 2), (256, 14, 1, 1), (256, 14, 3, 1), (256, 28, 3, 2),
        (256, 56, 1, 1), (256, 56, 1, 2), (512, 7, 1, 1), (512, 7, 3, 1),
        (512, 14, 3, 2), (512, 28, 1, 1), (512, 28, 1, 2), (1024, 14, 1, 1),
        (1024, 14, 1, 2), (2048, 7, 1, 1))]
EDGES = [
    ((2, 3, 224, 224), (7, 7), (2, 2), 3, False, False),    # stem
    ((2, 256, 56, 56), (1, 1), (2, 2), 0, False, False),    # 1x1 s2
    ((4, 512, 7, 7), (1, 1), (1, 1), 0, False, False),      # 1x1 on 7x7
    ((2, 160, 14, 14), (1, 1), (1, 1), 0, False, True),     # channels-last
    ((3, 8, 10, 10), (3, 3), (1, 1), 1, False, True),
    ((2, 200, 14, 14), (1, 1), (1, 1), 0, True, False),     # bias
    ((7, 3, 9, 9), (3, 3), (2, 2), 'SAME', True, False),
    ((3, 5, 7, 7), (3, 3), (1, 1), 1, False, False),        # rows 147
    ((2, 4, 9, 9), (3, 3), (1, 1), 0, False, False),        # padding 0
    ((2, 3, 20, 20), (7, 7), (1, 1), 3, True, False),       # padding 3
    ((2, 3, 8, 8), (3, 3), (2, 2), 'SAME', False, False),   # (0, 1) pads
    ((2, 6, 5, 5), (1, 1), (1, 1), 1, False, False),        # padded 1x1
    ((1, 40, 6, 6), (1, 1), (1, 1), 0, True, False),        # one image
    ((2, 17, 5, 3), (3, 2), (1, 2), ((1, 0), (0, 1)), False, False),
]
CASES = RESNET32 + RESNET50 + EDGES


def _id(case):
    shape, k, s, pad, bias, cl = case
    return (f'{"x".join(map(str, shape))}-k{k[0]}{k[1]}-s{s[0]}{s[1]}-p'
            f'{pad}{"+b" if bias else ""}{"-cl" if cl else ""}'
            ).replace(' ', '')


IDS = [_id(c) for c in CASES]


def _input(shape, channels_last, fill=False):
    x = torch.empty(shape)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    if fill:
        x.copy_(torch.arange(x.numel(), dtype=torch.float32).reshape(shape)
                + 1.0)
    return x


def _pads(x, k, s, pad):
    return kernels._canonical_pad(pad, k, tuple(x.shape[2:]), s)


def _plan(case, x=None, **kw):
    shape, k, s, pad, bias, cl = case
    x = _input(shape, cl) if x is None else x
    return kernels.patch_cov_plan(tuple(x.shape), x.stride(), k, s,
                                  _pads(x, k, s, pad), bias, **kw)


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_geometry_matches_the_conv(case):
    shape, k, s, pad, bias, cl = case
    x = _input(shape, cl)
    p = _plan(case, x)
    (ph, _), (pw, _) = _pads(x, k, s, pad)
    _, oh, ow = kernels.conv_out_geometry(shape, k, s, pad)
    assert (p.oh, p.ow, p.ph, p.pw) == (oh, ow, ph, pw)
    assert p.rows == shape[0] * oh * ow
    assert p.d_in == shape[1] * k[0] * k[1]


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_chunks_cover_rows_once(case):
    p = _plan(case)
    assert p.rows_per_chunk % 32 == 0 and p.rows_per_chunk > 0
    starts = [c * p.rows_per_chunk for c in range(p.chunks)]
    covered = np.zeros(p.rows, dtype=int)
    for st in starts:
        covered[st:min(p.rows, st + p.rows_per_chunk)] += 1
    assert (covered == 1).all()
    assert starts[-1] < p.rows        # no empty chunk


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_pairs_cover_lower_triangle_once(case):
    p = _plan(case)
    assert p.tile in (32, 64, 128)
    assert p.ntiles == -(-p.d_in // p.tile)
    assert p.npairs == p.ntiles * (p.ntiles + 1) // 2
    pairs = [kernels._pair_of(q) for q in range(p.npairs)]
    assert pairs == [(a, b) for a in range(p.ntiles) for b in range(a + 1)]


def _unpadded_1x1_s1(case, x):
    shape, k, s, pad, _, _ = case
    h, w = shape[2:]
    return (tuple(k) == (1, 1) and tuple(s) == (1, 1)
            and _pads(x, k, s, pad) == ((0, 0), (0, 0))
            and not (h > 1 and w > 1 and x.stride(2) != w * x.stride(3)))


@pytest.mark.parametrize('aligned', [True, False], ids=['aligned', 'not'])
@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_staging_path_rule(case, aligned):
    """1 x 1 stride-1 unpadded convs take K1's path by K1's rule, with
    K1's row geometry; everything else the implicit im2col."""
    x = _input(case[0], case[5])
    p = _plan(case, x, aligned=aligned)
    if _unpadded_1x1_s1(case, x):
        k1 = kernels.factor_ema_plan(tuple(x.shape), x.stride(), case[4],
                                     aligned=aligned)
        assert p.path == k1.path
        assert (p.inner, p.sb, p.ss, p.sc) == (k1.inner, k1.sb, k1.ss,
                                               k1.sc)
    else:
        assert p.path == 'patch4'
        assert (p.inner, p.sb, p.ss, p.sc) == (0, 0, 0, 0)


def test_staging_paths_at_resnet50_shapes():
    paths = {}
    for case in RESNET50:
        paths.setdefault(_plan(case).path, []).append(case[0][2])
    # 1 x 1 stride 1: 16-byte copies on 56/28/14 grids, 4-byte on 7 x 7;
    # every 3 x 3, the stem and the 1 x 1 stride-2 convs: patch4.
    assert sorted(paths) == ['kmajor16', 'kmajor4', 'patch4']
    assert sorted(set(paths['kmajor16'])) == [14, 28, 56]
    assert set(paths['kmajor4']) == {7}
    assert len(paths['patch4']) == 11


def test_uncollapsible_1x1_takes_patch4():
    x = torch.empty(2, 3, 8, 6)[:, :, ::2, :]
    p = kernels.patch_cov_plan(tuple(x.shape), x.stride(), (1, 1), (1, 1),
                               ((0, 0), (0, 0)), False)
    assert p.path == 'patch4'


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_workspace_matches_allocation(case):
    p = _plan(case)
    floats = p.chunks * p.npairs * p.tile * p.tile
    if case[4]:
        floats += p.chunks * p.ntiles * p.tile
    assert p.ws_bytes == 4 * floats
    ws = kernels._plan_workspace(p, 'cpu')
    assert ws.dtype == torch.float32 and ws.numel() * 4 == p.ws_bytes


@pytest.mark.parametrize('d,tile', [(144, 64), (288, 64), (576, 64),
                                    (4608, 128)])
def test_tile_by_width(d, tile):
    """The tile the model picks for the ResNet-32 widths (batch 128; 144,
    288, 576: a 128-wide tile would pad 144 to 256 and 576 to 640) and
    ResNet-50's widest conv (512 x 3 x 3 on a 7 x 7 grid, batch 64)."""
    c = d // 9
    hw = {16: 32, 32: 16, 64: 8, 512: 7}[c]
    shape = (64 if c == 512 else 128, c, hw, hw)
    p = _plan((shape, (3, 3), (1, 1), 1, False, False))
    assert p.tile == tile


def test_plan_picks_the_fastest_modelled_tile():
    for case in RESNET32 + RESNET50:
        shape, k, s, pad, bias, cl = case
        x = _input(shape, cl)
        p = _plan(case, x)
        every = [kernels._k2_plan(shape, x.stride(), k, s,
                                  _pads(x, k, s, pad), bias, tile, 132, True)
                 for tile in (32, 64, 128)]
        assert p.us == min(q.us for q in every)
        assert p in every


def _gather(x, p, k, s):
    """The kernel's copies of every row any chunk stages (rows past the
    last read zero) and every feature of the padded width, restated in
    int32 arithmetic: ``patch4``'s column descriptors (offset and packed
    tap shift; a feature past the last gets a shift outside every image),
    row decode and unsigned bounds check, or K1's row geometry."""
    b, c, h, w = x.shape
    sb, sc, sh, sw = x.stride()
    kh, kw = k
    n = x.untyped_storage().nbytes() // 4 - x.storage_offset()
    flat = torch.as_strided(x, (n,), (1,), x.storage_offset()).numpy()
    i32 = np.int32
    r = np.arange(p.chunks * p.rows_per_chunk, dtype=i32)
    f = np.arange(p.ntiles * p.tile, dtype=i32)
    rok = r < p.rows
    if p.path == 'patch4':
        kj, q = f % kw, f // kw
        ki, ch = q % kh, q // kh
        dh, dw = ki - i32(p.ph), kj - i32(p.pw)
        off = (ch * sc + dh * sh + dw * sw).astype(i32)
        dhw = ((dh.astype(np.uint32) << np.uint32(16))
               | (dw.astype(np.uint32) & np.uint32(0xffff))).view(i32)
        off[f >= p.d_in] = 0
        dhw[f >= p.d_in] = -(1 << 30)
        ow, q = r % p.ow, r // p.ow
        oh, bb = q % p.oh, q // p.oh
        h0, w0 = (oh * s[0]).astype(i32), (ow * s[1]).astype(i32)
        roff = (bb * sb + h0 * sh + w0 * sw).astype(i32)
        hh = (h0[:, None] + (dhw >> 16)[None, :]).view(np.uint32)
        ww = (w0[:, None] + (dhw & 0xffff).astype(np.uint16).view(np.int16)
              .astype(i32)[None, :]).view(np.uint32)
        ok = rok[:, None] & (hh < h) & (ww < w)
        addr = roff[:, None] + off[None, :]
    else:
        if p.inner == 1:
            roff = r * i32(p.sb)
        else:
            roff = (r // p.inner) * i32(p.sb) + (r % p.inner) * i32(p.ss)
        addr = roff[:, None] + (f * i32(p.sc))[None, :]
        ok = rok[:, None] & (f < p.d_in)[None, :]
    assert addr.dtype == i32
    return np.where(ok, flat[np.where(ok, addr, 0)], np.float32(0))


# Full-batch ResNet shapes are gathered at batch 2 (the kernel's
# arithmetic does not depend on the batch beyond the row decode).
GATHER = [((2,) + c[0][1:],) + c[1:] for c in RESNET32 + RESNET50] + EDGES


@pytest.mark.parametrize('case', GATHER, ids=[_id(c) for c in GATHER])
def test_kernel_addressing_gathers_the_patch_rows(case):
    shape, k, s, pad, bias, cl = case
    x = _input(shape, cl, fill=True)
    p = _plan(case, x)
    got = _gather(x, p, k, s)
    ref = kernels.extract_conv2d_patches(x, k, s, pad).numpy()
    assert np.array_equal(got[:p.rows, :p.d_in], ref)
    assert not got[p.rows:].any() and not got[:, p.d_in:].any()


def test_padding_taps_read_zero():
    # All-ones input: the gathered patch rows count each row's taps that
    # fall inside the image (a 3 x 3 window at a corner of a padded 4 x 4
    # image keeps 4 of its 9 taps).
    x = torch.ones(1, 1, 4, 4)
    case = ((1, 1, 4, 4), (3, 3), (1, 1), 1, False, False)
    got = _gather(x, _plan(case, x), (3, 3), (1, 1))
    assert got[0, :9].sum() == 4 and got[5, :9].sum() == 9
