"""The plan of the K3 bucketed-preconditioning kernel
(``bucket_precond_plan``).

The CUDA kernel runs only on the card; what decides how it walks a bucket
-- the tile height, the staging path, the output tiles and v.g partials
per slice, the waves and the workspace -- is Python, checked here on the
CPU at every ResNet-32 and ResNet-50 bucket, the LSTM LM's bucket and
ragged edge cases. The arguments the wrapper hands the library are
checked through ctypes prototypes of the C entry points. All checks are
exact (integer bookkeeping).
"""

import ctypes

import pytest
import torch

from distributed_kfac_pytorch_tpu_torch.ops import kernels

# (slices, G, A): the K3 buckets of one K-FAC step.
RESNET32 = [(1, 16, 27), (10, 16, 144), (1, 32, 144), (9, 32, 288),
            (1, 64, 288), (9, 64, 576), (1, 10, 65)]
# ResNet-50 at 224 px: every (G, A) bucket with its layer count (conv
# weights (out, in * kh * kw), the head (1000, 2048 + bias)).
RESNET50 = [(1, 64, 64), (1, 64, 147), (2, 64, 256), (3, 64, 576),
            (1, 128, 256), (3, 128, 512), (4, 128, 1152), (4, 256, 64),
            (1, 256, 512), (5, 256, 1024), (6, 256, 2304), (4, 512, 128),
            (1, 512, 256), (1, 512, 1024), (2, 512, 2048), (3, 512, 4608),
            (1, 1000, 2049), (6, 1024, 256), (1, 1024, 512), (3, 2048, 512),
            (1, 2048, 1024)]
LSTM = [(16, 650, 651)]
EDGES = [(1, 1, 1), (2, 70, 130), (3, 10, 65), (1, 65, 129), (2, 128, 128),
         (1, 129, 4), (4, 3, 4096), (65, 8, 8)]
CASES = RESNET32 + RESNET50 + LSTM + EDGES
IDS = ['x'.join(map(str, c)) for c in CASES]


def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize('eigen', [True, False], ids=['eigen', 'baked'])
@pytest.mark.parametrize('s,g_dim,a_dim', CASES, ids=IDS)
def test_tiles_cover_output_once(s, g_dim, a_dim, eigen):
    p = kernels.bucket_precond_plan(s, g_dim, a_dim, eigen)
    assert p.tile_m in (64, 128)
    rows, cols = _ceil(g_dim, p.tile_m), _ceil(a_dim, kernels._K3_TILE_N)
    # The tiles cover M = G and N = A, and none starts past the edge.
    assert rows * p.tile_m >= g_dim > (rows - 1) * p.tile_m
    assert cols * kernels._K3_TILE_N >= a_dim > (
        cols - 1) * kernels._K3_TILE_N
    # One v.g partial per output tile: the grid's x * y
    # (csrc/gemm_tc.cuh tc_tile_grid, x over A, y over G).
    assert p.tiles == rows * cols
    slots = 132 * kernels._K3_BLOCKS_PER_SM[p.tile_m]
    assert p.waves == _ceil(s * p.tiles, slots)


@pytest.mark.parametrize('s,g_dim,a_dim', CASES, ids=IDS)
def test_16_byte_path_exactly_when_aligned(s, g_dim, a_dim):
    p = kernels.bucket_precond_plan(s, g_dim, a_dim, True)
    assert p.path in kernels._K3_STAGING
    assert (p.path == 'vec16') == (g_dim % 4 == 0 and a_dim % 4 == 0)
    unaligned = kernels.bucket_precond_plan(s, g_dim, a_dim, True,
                                            aligned=False)
    assert unaligned.path == 'vec4'


@pytest.mark.parametrize('eigen', [True, False], ids=['eigen', 'baked'])
@pytest.mark.parametrize('s,g_dim,a_dim', CASES, ids=IDS)
def test_workspace_matches_allocation(s, g_dim, a_dim, eigen):
    p = kernels.bucket_precond_plan(s, g_dim, a_dim, eigen)
    ws, (u, t, vg_part) = kernels._bucket_precond_workspace(p, 'cpu')
    n = s * g_dim * a_dim
    assert ws.dtype == torch.float32 and ws.numel() == p.ws_floats
    # U, then T (eigen; the baked chain has none and its partials follow
    # U), then the v.g partials: what the last product writes (s slices x
    # tiles) and the reduction reads, up to the end of the allocation.
    assert (u, t) == (0, n)
    assert vg_part == (2 if eigen else 1) * n
    assert p.ws_floats - vg_part == s * p.tiles
    if p.path == 'vec16':
        # T is read with 16-byte copies: it starts 16-byte aligned.
        assert (4 * t) % 16 == 0


@pytest.mark.parametrize('s,g_dim', [(1, 16), (10, 16), (9, 32), (9, 64),
                                     (3, 64), (1, 10)])
def test_small_g_takes_64_row_tiles(s, g_dim):
    # A 128-row tile would be half empty or worse at G <= 64.
    assert kernels.bucket_precond_plan(s, g_dim, 576, True).tile_m == 64


def test_plan_picks_the_modelled_cheapest_tile():
    for s, g_dim, a_dim in RESNET50 + LSTM:
        chosen = kernels.bucket_precond_plan(s, g_dim, a_dim, False)
        other = kernels._k3_plan(s, g_dim, a_dim, False, chosen.path,
                                 192 - chosen.tile_m, 132)
        assert chosen.us_per_ktile <= other.us_per_ktile


@pytest.mark.parametrize('path', ['vec16', 'vec4'])
def test_cost_model_counts_the_busiest_sm(path):
    us = kernels._K3_US_PER_KTILE
    # 132 blocks: one per SM either way.
    p = kernels._k3_plan(1, 128 * 11, 128 * 12, False, path, 128, 132)
    assert p.us_per_ktile == us[path, 128, 1]
    p = kernels._k3_plan(1, 64 * 11, 128 * 12, False, path, 64, 132)
    assert p.us_per_ktile == us[path, 64, 1]
    # 133 64-row blocks: two share one SM; 397 = 3 * 132 + 1: the busiest
    # SM runs two pairs.
    p = kernels._k3_plan(1, 64 * 7, 128 * 19, False, path, 64, 132)
    assert p.us_per_ktile == us[path, 64, 2]
    p = kernels._k3_plan(1, 64 * 397, 128, False, path, 64, 132)
    assert p.us_per_ktile == 2 * us[path, 64, 2]
    assert p.waves == 2


def test_plan_waves_at_the_heaviest_bucket():
    # (512, 4608) x 3: 432 128-row tiles (3.3 waves at one block per SM),
    # 864 64-row tiles (3.3 waves at two).
    p128 = kernels._k3_plan(3, 512, 4608, False, 'vec16', 128, 132)
    p64 = kernels._k3_plan(3, 512, 4608, False, 'vec16', 64, 132)
    assert 3 * p128.tiles == 432 and p128.waves == 4
    assert 3 * p64.tiles == 864 and p64.waves == 4


def test_plan_rejects_empty_bucket():
    with pytest.raises(ValueError, match='empty'):
        kernels.bucket_precond_plan(0, 4, 4, True)


class _FakeLib:
    """C entry points of csrc/bucket_precond.cu as ctypes prototypes around
    recorders: a wrong argument count or type raises as the real library
    call would."""

    def __init__(self):
        self.calls = []
        self._keep = []
        for fn, argtypes in kernels._SIGNATURES['bucket_precond'].items():
            proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)

            def rec(*args, fn=fn):
                self.calls.append((fn, args))
                return 0
            cfn = proto(rec)
            self._keep.append(cfn)
            setattr(self, fn, cfn)


@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('eigen', [True, False], ids=['eigen', 'baked'])
@pytest.mark.parametrize('s,g_dim,a_dim', [(2, 70, 130), (3, 64, 576)],
                         ids=['2x70x130', '3x64x576'])
def test_launch_hands_the_plan_to_the_library(s, g_dim, a_dim, eigen, bf16,
                                              monkeypatch):
    fake = _FakeLib()
    monkeypatch.setattr(kernels, '_lib', lambda name: fake)
    monkeypatch.setattr(kernels, '_stream', lambda t: 0)
    monkeypatch.setitem(kernels.LAUNCHES, 'bucket_precond',
                        kernels.LAUNCHES['bucket_precond'])
    g = torch.zeros((s, g_dim, a_dim))
    if eigen:
        entry = {'QA': torch.zeros(s, a_dim, a_dim),
                 'QG': torch.zeros(s, g_dim, g_dim),
                 'dA': torch.zeros(s, a_dim), 'dG': torch.zeros(s, g_dim)}
    else:
        entry = {'A_inv': torch.zeros(s, a_dim, a_dim),
                 'G_inv': torch.zeros(s, g_dim, g_dim)}
    plan = kernels.bucket_precond_plan(s, g_dim, a_dim, eigen)
    before = kernels.LAUNCHES['bucket_precond']
    v, vg = kernels._bucket_precond_launch(plan, g, entry, 0.003, bf16)
    assert kernels.LAUNCHES['bucket_precond'] == before + 1
    assert v.shape == g.shape and vg.shape == (s,)
    (fn, args), = fake.calls
    assert fn == ('kfac_bucket_precond_eigen' if eigen
                  else 'kfac_bucket_precond_baked')
    at = 6 if eigen else 3          # after the operand pointers (+ damping)
    assert args[at:at + 6] == (s, g_dim, a_dim, plan.tile_m,
                               kernels._K3_STAGING.index(plan.path),
                               int(bf16))
    assert args[0] == g.data_ptr()
    # The workspace pointers: U, (T,) the v.g partials, then v and vg.
    ws = args[at + 6:at + (9 if eigen else 8)]
    n = s * g_dim * a_dim
    expect = (0, 4 * n, 8 * n) if eigen else (0, 4 * n)
    assert tuple(w - ws[0] for w in ws) == expect
    assert args[-3] == v.data_ptr() and args[-2] == vg.data_ptr()


def test_resnet50_buckets_are_the_models():
    import chip_smoke
    buckets = chip_smoke.resnet50_shapes()['buckets']
    assert sorted(RESNET50, key=lambda c: c[1:]) == [
        (n, g_dim, a_dim) for (g_dim, a_dim), n in buckets]
