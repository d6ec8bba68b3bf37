"""Hand-written Hopper kernels of the K-FAC hot path, with their wrappers,
plain PyTorch versions and launch counters.

The counterpart of ``distributed_kfac_pytorch_tpu/ops/pallas_kernels.py``.
Five kernels carry the single-device K-FAC step:

  ``factor_ema``     K1, ``csrc/factor_ema.cu`` -- factor contraction +
                     bias assembly + EMA blend (replaces
                     ``pallas_kernels._factor_ema_kernel`` via
                     ``fused_factor_ema``);
  ``patch_cov``      K2, ``csrc/patch_cov.cu`` -- conv-A patch covariance
                     with implicit im2col (replaces
                     ``pallas_kernels._patch_cov_kernel`` via
                     ``conv_a_factor_fused``);
  ``bucket_precond`` K3, ``csrc/bucket_precond.cu`` -- bucketed eigen or
                     baked preconditioning with the KL-clip ``v.g``
                     partial (replaces
                     ``pallas_kernels._bucket_precond_kernel`` via
                     ``fused_bucket_precondition``);
  ``ns_inverse``     K4, ``csrc/ns_inverse.cu`` -- batched damped SPD
                     inverse by Newton--Schulz (replaces
                     ``pallas_kernels._ns_inverse_kernel`` via
                     ``batched_inverse`` / ``damped_inverse_stack``);
  ``jacobi_eigh``    K5, ``csrc/jacobi_eigh.cu`` -- batched Brent--Luk
                     parallel Jacobi eigh (replaces
                     ``pallas_kernels._jacobi_eigh_kernel`` via
                     ``batched_jacobi_eigh``).

K1 and K2 run on the split-K Gram engine of ``csrc/gram_tc.cuh``, K3 and
K4 on the tile GEMM of ``csrc/gemm_tc.cuh``, all by 3xTF32 on the tensor
cores. Each wrapper
runs its kernel's plain version for tensors on the CPU and launches the
CUDA kernel for tensors on the card, bf16 inputs (captures, inverse
stacks) widened to fp32 first and K1 blending into fp32 or bf16 factor
storage; any other device, dtype or layout raises. There is no fallback: a build or launch failure raises.
Each launch adds one to ``LAUNCHES[name]`` (launches only: the plain
versions do not count).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
``_build/`` (one shared library per source, all compiled in parallel) and
loaded with ``ctypes``. Nothing is compiled or imported at module import.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from distributed_kfac_pytorch_tpu_torch.observability import profiling
from distributed_kfac_pytorch_tpu_torch.ops import linalg

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
SOURCES = {'factor_ema': 'factor_ema.cu', 'patch_cov': 'patch_cov.cu',
           'bucket_precond': 'bucket_precond.cu',
           'ns_inverse': 'ns_inverse.cu', 'jacobi_eigh': 'jacobi_eigh.cu'}
HEADERS = ('gram_tc.cuh', 'gemm_tc.cuh')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {name: 0 for name in SOURCES}

# Rows of one staged k-tile of the Gram kernels K1 and K2 (gemm_tc.cuh's
# kTcK); split-K chunks are multiples of it.
_ROW_STEP = 32

_LIBS: dict[str, ctypes.CDLL] = {}

#: First-use builds and loads of the kernel libraries not yet drained
#: (:func:`drain_build_events`), each a ``compile`` event of the metrics
#: stream (``observability.sink.EVENT_KINDS``).
_BUILD_EVENTS: list[dict] = []


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Precision and conv geometry helpers (shared with ops.factors)
# ---------------------------------------------------------------------------

def mult_bf16(compute_dtype) -> bool:
    """True when ``compute_dtype`` asks for bf16-rounded multiplicands."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return False
    if compute_dtype == torch.bfloat16:
        return True
    raise ValueError(
        f'compute_dtype must be None, torch.float32 or torch.bfloat16, '
        f'got {compute_dtype!r}')


def _round(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    x = x.float()
    return x.bfloat16().float() if bf16 else x


def _canonical_pad(padding, kernel_size, spatial, strides):
    """Per-axis ``((lo, hi), (lo, hi))`` pad amounts, XLA conventions.

    'SAME' follows the XLA/TF formula -- total = max((ceil(dim/s)-1)*s
    + k - dim, 0), lo = total // 2, extra on the high side -- so strided
    convs pad as the JAX package does. Also accepts 'VALID', an int, a
    per-axis ``(ph, pw)`` pair of ints (torch's ``Conv2d.padding``) and
    explicit ``((lo, hi), (lo, hi))`` pairs.
    """
    kh, kw = kernel_size
    h, w = spatial
    sh, sw = strides
    if isinstance(padding, str):
        if padding.upper() == 'VALID':
            return ((0, 0), (0, 0))
        if padding.upper() == 'SAME':
            out = []
            for dim, k, s in ((h, kh, sh), (w, kw, sw)):
                o = -(-dim // s)
                total = max((o - 1) * s + k - dim, 0)
                out.append((total // 2, total - total // 2))
            return tuple(out)
        raise ValueError(f'unsupported padding {padding!r}')
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    ph, pw = padding
    ph = (ph, ph) if isinstance(ph, int) else tuple(ph)
    pw = (pw, pw) if isinstance(pw, int) else tuple(pw)
    return (ph, pw)


def conv_out_geometry(x_shape, kernel_size, strides, padding):
    """(pads, oh, ow) of a conv over a (B, C, H, W) input."""
    _, _, h, w = x_shape
    kh, kw = kernel_size
    sh, sw = strides
    pads = _canonical_pad(padding, (kh, kw), (h, w), (sh, sw))
    (ph_lo, ph_hi), (pw_lo, pw_hi) = pads
    oh = (h + ph_lo + ph_hi - kh) // sh + 1
    ow = (w + pw_lo + pw_hi - kw) // sw + 1
    return pads, oh, ow


def extract_conv2d_patches(x: torch.Tensor, kernel_size, strides,
                           padding) -> torch.Tensor:
    """im2col: ``(B, C, H, W)`` -> ``(B*OH*OW, C*KH*KW)`` patch rows.

    Rows are ordered ``(b, oh, ow)`` and features ``(c, kh, kw)`` with
    ``kw`` fastest, matching torch's flattened conv weight. Built from the
    padded input's ``KH*KW`` strided views (the JAX ``slices`` path).
    """
    kh, kw = kernel_size
    sh, sw = strides
    b, c = x.shape[:2]
    ((ph_lo, ph_hi), (pw_lo, pw_hi)), oh, ow = conv_out_geometry(
        x.shape, kernel_size, strides, padding)
    xp = torch.nn.functional.pad(x, (pw_lo, pw_hi, ph_lo, ph_hi))
    views = [xp[:, :, ki:ki + sh * (oh - 1) + 1:sh,
                kj:kj + sw * (ow - 1) + 1:sw]
             for ki in range(kh) for kj in range(kw)]
    p = torch.stack(views, dim=2)                  # (B, C, KH*KW, OH, OW)
    return p.permute(0, 3, 4, 1, 2).reshape(b * oh * ow, c * kh * kw)


def _gram_rows(x: torch.Tensor) -> torch.Tensor:
    """The ``(rows, d)`` matrix a Gram kernel reads: a 2-D tensor as is,
    a 4-D ``(B, C, H, W)`` output-grad as ``(B*H*W, C)``."""
    if x.ndim == 2:
        return x
    if x.ndim == 4:
        return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    raise ValueError(f'expected a 2-D or 4-D tensor, got shape '
                     f'{tuple(x.shape)}')


def _assemble_bias_factor(cov: torch.Tensor, bias_col: torch.Tensor,
                          corner) -> torch.Tensor:
    """[[cov, b], [b^T, corner]]: the covariance of rows with an appended
    ones column, without materializing the (rows, d + 1) concatenation."""
    d = cov.shape[0]
    out = cov.new_zeros((d + 1, d + 1))
    out[:d, :d] = cov
    out[d, :d] = bias_col
    out[:d, d] = bias_col
    out[d, d] = corner
    return out


def ema_new_weight(decay) -> float:
    """``1 - decay`` as K1's blend takes it: in fp32, from the fp32
    ``decay``."""
    return float(np.float32(1.0) - np.float32(decay))


def ema_blend(old: torch.Tensor, new: torch.Tensor, decay) -> torch.Tensor:
    """``decay * old + (1 - decay) * new`` rounded as K1's fused blend
    rounds it on the card: ``decay * old`` rounded, then ``(1 - decay) *
    new`` fused into the sum (``torch.add``'s ``alpha``, with
    :func:`ema_new_weight`). Every EMA of the port takes this form, so the
    separate EMA of a distributed step gives the fused kernel's bits.

    The result has ``old``'s dtype: an ``old`` stored in bf16 is widened,
    blended in fp32 with the fp32 ``new`` and rounded once (to nearest
    even), as K1's bf16-storage blend does."""
    out = torch.add(old.float() * decay, new, alpha=ema_new_weight(decay))
    return out.to(old.dtype)


def _finish_gram(acc: torch.Tensor, colsum: torch.Tensor | None,
                 inv_scale: float, bias_scale: float, corner: float,
                 old: torch.Tensor | None, decay) -> torch.Tensor:
    """Scale, bias-assemble and EMA-blend a summed Gram (plain versions);
    the result has ``old``'s dtype (fp32 without ``old``)."""
    cov = (acc + acc.T) * (0.5 * inv_scale)
    if colsum is not None:
        cov = _assemble_bias_factor(cov, colsum * bias_scale, corner)
    if old is None:
        return cov
    return ema_blend(old, cov, decay)


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = Path(cuda_home) / 'bin' / 'nvcc'
    if path.exists():
        return str(path)
    raise RuntimeError('nvcc not found (searched PATH and $CUDA_HOME/bin): '
                       'the CUDA kernels cannot be built')


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for fname in (SOURCES[name], *HEADERS):
        h.update((CSRC / fname).read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


@contextlib.contextmanager
def build_lock(build_dir: Path | None = None):
    """Hold an exclusive ``fcntl`` lock on ``_build/.lock``: the ranks of
    one host that reach their first kernel together build once, the
    others wait and find the libraries made."""
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / '.lock', 'w') as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(verbose: bool = False) -> dict[str, Path]:
    """Compile every kernel source that has no up-to-date library yet,
    one ``nvcc`` per source, all started together, under
    :func:`build_lock`. Raises on failure."""
    paths = {name: _lib_path(name) for name in SOURCES}
    if all(p.exists() for p in paths.values()):
        return paths
    with build_lock():
        return _build_locked(paths, verbose)


def _build_locked(paths: dict[str, Path], verbose: bool
                  ) -> dict[str, Path]:
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-I', str(CSRC), '-o', str(tmp),
               str(CSRC / SOURCES[name])]
        if verbose:
            cmd[1:1] = ['-Xptxas', '-v']
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f'{SOURCES[name]}: nvcc exit {proc.returncode}\n'
                          f'{out}')
            continue
        if verbose and out:
            print(f'[nvcc {SOURCES[name]}]\n{out}')
        os.replace(tmp, path)
    if errors:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(errors))
    return paths


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    'factor_ema': {
        'kfac_factor_ema': [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P, _P, _F, _F, _I, _F, _F, _P, _I, _P]},
    'patch_cov': {
        'kfac_patch_cov': [_P, *[_I] * 25, _P, _F, _I, _F, _F, _P, _P]},
    'bucket_precond': {
        'kfac_bucket_precond_eigen': [_P, _P, _P, _P, _P, _F, _I, _I, _I,
                                      _I, _I, _I, _P, _P, _P, _P, _P, _P],
        'kfac_bucket_precond_baked': [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _P, _P, _P, _P, _P]},
    'ns_inverse': {
        'kfac_ns_inverse': [_P, _F, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P,
                            _P]},
    'jacobi_eigh': {
        'kfac_jacobi_eigh': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        'kfac_jacobi_eigh_cluster': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _P],
        'kfac_jacobi_cluster_occupancy': [_I, _I, _P]},
}


def _lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``. The first call builds what
    is missing (:func:`build`) and loads every library, and records the
    wall time as a pending ``compile`` event (:func:`drain_build_events`):
    ``variant`` 'kernels', the libraries loaded, how many were built and
    ``first_call_ms``."""
    lib = _LIBS.get(name)
    if lib is None:
        t0 = time.perf_counter()
        missing = [n for n in SOURCES if not _lib_path(n).exists()]
        paths = build()
        loaded = []
        for n, path in paths.items():
            if n in _LIBS:
                continue
            handle = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES[n].items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
            _LIBS[n] = handle
            loaded.append(n)
        _BUILD_EVENTS.append({
            'event': 'compile', 'variant': 'kernels',
            'libraries': ','.join(loaded), 'built': len(missing),
            'first_call_ms': (time.perf_counter() - t0) * 1000.0})
        lib = _LIBS[name]
    return lib


def drain_build_events() -> list[dict]:
    """The pending first-use build / load events, emptied: the training
    engine writes them into the metrics stream after the step that
    triggered them."""
    out = list(_BUILD_EVENTS)
    _BUILD_EVENTS.clear()
    return out


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


#: The storage dtypes of a running factor that K1 blends into.
_STORAGE_DTYPES = (torch.float32, torch.bfloat16)


def _require(t: torch.Tensor, what: str, ndim: int | None = None,
             dtypes=(torch.float32,)) -> None:
    if not t.is_cuda:
        raise ValueError(f'{what}: expected a CUDA tensor, got device '
                         f'{t.device}')
    if t.dtype not in dtypes:
        names = ' or '.join(str(d).replace('torch.', '') for d in dtypes)
        raise ValueError(f'{what}: expected {names}, got {t.dtype}')
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f'{what}: expected {ndim}-D, got shape '
                         f'{tuple(t.shape)}')


#: The half-precision input dtypes the wrappers widen to fp32.
_HALF_DTYPES = (torch.bfloat16, torch.float16)


def _widened(t: torch.Tensor) -> torch.Tensor:
    """A bf16 or fp16 tensor as fp32 (the kernels read fp32), others as
    they are. The wrappers widen their half-precision inputs with it
    before any check, as the JAX wrappers widen every input dtype before
    their Pallas calls (``pallas_kernels.py:731, 903-920``); the widening
    is exact."""
    return t.float() if t.dtype in _HALF_DTYPES else t


def _require_int32_offsets(x: torch.Tensor, what: str) -> None:
    """The Gram kernels address their input with 32-bit element offsets."""
    span = sum((n - 1) * abs(s) for n, s in zip(x.shape, x.stride()))
    if span >= 2 ** 31:
        raise ValueError(f'{what}: input spans {span + 1} elements; the '
                         'kernel takes at most 2**31 (32-bit offsets)')


def _dispatch_device(x: torch.Tensor, what: str) -> bool:
    """True for the CUDA kernel, False for the plain version (CPU tensors
    only); anything else raises."""
    if x.is_cuda:
        return True
    if x.device.type == 'cpu':
        return False
    raise ValueError(f'{what}: unsupported device {x.device}')


# ---------------------------------------------------------------------------
# K1: factor contraction + EMA. Replaces pallas_kernels._factor_ema_kernel
# (pallas_kernels.py:593, driven by _pallas_factor_ema :661 /
# fused_factor_ema :696). Bound on the H100: bytes at ResNet-32 widths
# (conv G reads up to (131072, 16) fp32 rows for a 16 x 16 output),
# operations at ResNet-50's d >= 128 (~13 GFLOP per heavy conv G launch).
# The kernel runs the products on the tensor cores (3xTF32 mma.sync over a
# cp.async ring, gemm_tc.cuh), stages X^T tiles K-major straight from the
# caller's strides (no permuted or padded copy), computes lower-triangle
# tile pairs only, and splits the row walk over about one or two waves of
# resident blocks (split-K, fixed-order second pass that mirrors each
# upper entry from its lower one: exactly symmetric, deterministic).
# factor_ema_plan decides the tile, split and staging path.
# ---------------------------------------------------------------------------

_K1_STAGING = ('kmajor16', 'kmajor4', 'feature4')  # csrc kPath 0, 1, 2
# Blocks per SM by tile edge (shared memory and the register cap).
_K1_BLOCKS_PER_SM = {32: 4, 64: 2, 128: 1}
# The split's cost model, microseconds on the H100 (chunk sweeps of the
# ResNet-32 and ResNet-50 K1 shapes under torch.profiler): a block's time
# per k-tile by tile edge, the finalize's time per chunk (its serial sum),
# and the card's memory rate in bytes per us.
_K1_US_PER_KTILE = {32: 0.55, 64: 1.5, 128: 2.6}
_K1_US_PER_CHUNK = 0.04
_K1_BYTES_PER_US = 3.35e6


@dataclasses.dataclass(frozen=True)
class FactorEmaPlan:
    """How K1 runs one input: its row geometry after collapsing (row r =
    (b, s), s < ``inner``, at ``b*sb + s*ss``; ``inner == 1``: row stride
    ``sb``), the tile edge, the lower-triangle tile pairs, the split-K
    chunks of ``rows_per_chunk`` rows, the staging path and the workspace
    (partial tiles, then column sums with a bias) in bytes."""
    rows: int
    d_in: int
    inner: int
    sb: int
    ss: int
    sc: int
    tile: int
    npairs: int
    chunks: int
    rows_per_chunk: int
    path: str
    ws_bytes: int

    @property
    def ntiles(self) -> int:
        return -(-self.d_in // self.tile)


def _pair_of(p: int) -> tuple[int, int]:
    """Pair index -> (ta, tb), ta >= tb, p = ta(ta+1)/2 + tb: the closed
    form of csrc/factor_ema.cu's ``pair_of`` (float32 sqrt, corrected)."""
    a = int((float(torch.tensor(8.0 * p + 1.0).sqrt()) - 1.0) * 0.5)
    while (a + 1) * (a + 2) // 2 <= p:
        a += 1
    while a * (a + 1) // 2 > p:
        a -= 1
    return a, p - a * (a + 1) // 2


@functools.lru_cache(maxsize=None)
def _gram_split(ktiles: int, npairs: int, slots: int, tile: int,
                us_per_ktile: float, in_bytes: int) -> tuple[int, float]:
    """(chunks, modelled us) of the Gram engine's row walk (K1, K2) that
    minimize the modelled time: waves of ``slots`` resident blocks times
    each block's k-tiles at ``us_per_ktile`` (at least the input read at
    the memory rate), plus the finalize's serial sum over chunks and the
    workspace written and read back."""
    best, best_us = 1, None
    for chunks in range(1, min(ktiles, max(1, 4 * slots // npairs)) + 1):
        waves = -(-npairs * chunks // slots)
        us = max(waves * (-(-ktiles // chunks) + 2) * us_per_ktile,
                 in_bytes / _K1_BYTES_PER_US)
        us += chunks * (_K1_US_PER_CHUNK
                        + 8 * npairs * tile * tile / _K1_BYTES_PER_US)
        if best_us is None or us < best_us:
            best, best_us = chunks, us
    return best, best_us


def _row_geometry(shape, strides, aligned: bool, what: str):
    """``(rows, d_in, inner, sb, ss, sc, path)`` of a ``(rows, d)`` or
    ``(B, C, H, W)`` input read as K1 reads it: rows collapsed to one
    strided axis where they can be (row r = (b, s), s < ``inner``, at
    ``b*sb + s*ss``; ``inner == 1``: row stride ``sb``), feature c at
    ``c*sc``, and the staging path (16-byte K-major where rows are
    unit-stride, 4-row groups stay in one image and starts are 16-byte
    aligned; 4-byte along features where features are unit-stride; else
    4-byte K-major). Raises on a 4-D input whose (h, w) axes do not
    collapse to one strided axis."""
    if len(shape) == 2:
        rows, d_in = shape
        inner, sb, ss, sc = 1, strides[0], 0, strides[1]
    elif len(shape) == 4:
        b, d_in, h, w = shape
        if h > 1 and w > 1 and strides[2] != w * strides[3]:
            raise ValueError(f'{what}: the (h, w) axes of a 4-D input '
                             'must collapse to one strided axis, got '
                             f'strides {strides}')
        rows, inner = b * h * w, h * w
        sb, sc = strides[0], strides[1]
        ss = strides[3] if w > 1 else strides[2]
        if inner == 1:
            ss = 0
        elif b == 1 or sb == inner * ss:
            inner, sb, ss = 1, ss, 0          # one strided row axis
    else:
        raise ValueError(f'{what}: expected 2-D or 4-D x, got shape '
                         f'{shape}')
    k_contig = (sb if inner == 1 else ss) == 1
    if k_contig and aligned and sc % 4 == 0 and (
            inner == 1 or (inner % 4 == 0 and sb % 4 == 0)):
        path = 'kmajor16'
    elif not k_contig and sc == 1:
        path = 'feature4'
    else:
        path = 'kmajor4'
    return rows, d_in, inner, sb, ss, sc, path


@functools.lru_cache(maxsize=1024)
def factor_ema_plan(shape, strides, has_bias: bool, device_sms: int = 132,
                    aligned: bool = True) -> FactorEmaPlan:
    """K1's plan for a ``(rows, d)`` or ``(B, C, H, W)`` input of element
    ``strides`` (``aligned``: its first element is 16-byte aligned) on a
    card of ``device_sms`` SMs (cached: one plan per layer shape). Raises
    on a 4-D input whose (h, w) axes do not collapse to one strided
    axis."""
    rows, d_in, inner, sb, ss, sc, path = _row_geometry(
        tuple(shape), tuple(strides), aligned, 'factor_ema')
    tile = 32 if d_in <= 32 else 64 if d_in <= 64 else 128
    ntiles = -(-d_in // tile)
    npairs = ntiles * (ntiles + 1) // 2
    ktiles = max(1, -(-rows // _ROW_STEP))
    chunks, _ = _gram_split(ktiles, npairs,
                            device_sms * _K1_BLOCKS_PER_SM[tile], tile,
                            _K1_US_PER_KTILE[tile], 4 * rows * d_in)
    per = -(-ktiles // chunks) * _ROW_STEP
    chunks = -(-rows // per) if rows else 1
    floats = chunks * npairs * tile * tile
    if has_bias:
        floats += chunks * ntiles * tile
    return FactorEmaPlan(rows, d_in, inner, sb, ss, sc, tile, npairs,
                         chunks, per, path, 4 * floats)


def _plan_workspace(plan, device) -> torch.Tensor:
    """The flat fp32 workspace of a K1 or K2 plan (``plan.ws_bytes``)."""
    return torch.empty(plan.ws_bytes // 4, dtype=torch.float32,
                       device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def factor_ema_plain(x: torch.Tensor, old: torch.Tensor | None, decay, *,
                     scale: float | None = None, has_bias: bool = False,
                     corner: float = 1.0, bf16: bool = False
                     ) -> torch.Tensor:
    """Plain version of K1: ``decay*old + (1-decay)*F`` with ``F`` the
    symmetrized ``x^T x / scale`` plus, with ``has_bias``, the bias
    row/column ``colsum(x)/rows`` and ``corner`` (``old=None``: ``F``). A
    bf16 ``old`` gives a bf16 result: the fp32 blend rounded once."""
    x2 = _round(_gram_rows(x), bf16)
    rows = x2.shape[0]
    scale = rows if scale is None else scale
    colsum = x2.sum(0) if has_bias else None
    return _finish_gram(x2.T @ x2, colsum, 1.0 / scale, 1.0 / rows,
                        corner, old, decay)


def factor_ema(x: torch.Tensor, old: torch.Tensor | None, decay, *,
               scale: float | None = None, has_bias: bool = False,
               corner: float = 1.0, compute_dtype=None) -> torch.Tensor:
    """Factor contraction + bias + EMA (K1); dense ``(n, n)`` result in
    ``old``'s dtype (fp32 without ``old``).

    ``x`` is the ``(rows, d_in)`` capture matrix, or a ``(B, C, H, W)``
    conv output-grad read in place as ``(B*H*W, C)`` (through its strides:
    no permuted copy is made); a bf16 or fp16 ``x`` (a half-precision
    capture) is widened to fp32 first. ``old`` is the running ``(n, n)``
    factor (``n = d_in + has_bias``), fp32 or bf16 (bf16 factor storage:
    the kernel reads it widened and writes the blend rounded to bf16, in
    the same launch), or None for the contraction alone; ``decay`` the EMA alpha. ``scale``
    defaults to the row count.
    """
    bf16 = mult_bf16(compute_dtype)
    if not _dispatch_device(x, 'factor_ema'):
        return factor_ema_plain(x, old, decay, scale=scale,
                                has_bias=has_bias, corner=corner, bf16=bf16)
    x = _widened(x)
    _require(x, 'factor_ema x')
    _require_int32_offsets(x, 'factor_ema')
    plan = factor_ema_plan(tuple(x.shape), x.stride(), bool(has_bias),
                           _sm_count(x.device.index or 0),
                           aligned=x.data_ptr() % 16 == 0)
    rows, d_in = plan.rows, plan.d_in
    n = d_in + int(has_bias)
    storage = torch.float32 if old is None else old.dtype
    if old is not None:
        _require(old, 'factor_ema old', 2, dtypes=_STORAGE_DTYPES)
        if tuple(old.shape) != (n, n) or not old.is_contiguous():
            raise ValueError(f'factor_ema: old must be a contiguous '
                             f'({n}, {n}) tensor, got {tuple(old.shape)}')
    if rows < 1:
        raise ValueError('factor_ema: x has no rows')
    scale = rows if scale is None else scale
    ws = _plan_workspace(plan, x.device)
    out = torch.empty((n, n), dtype=storage, device=x.device)
    err = _lib('factor_ema').kfac_factor_ema(
        x.data_ptr(), rows, d_in, plan.inner, plan.sb, plan.ss, plan.sc,
        int(bf16), plan.tile, _K1_STAGING.index(plan.path), plan.chunks,
        plan.rows_per_chunk, ws.data_ptr(),
        old.data_ptr() if old is not None else None,
        float(decay) if old is not None else 0.0, 1.0 / float(scale),
        int(has_bias), 1.0 / rows, float(corner), out.data_ptr(),
        int(storage == torch.bfloat16), _stream(x))
    _check(err, 'factor_ema')
    LAUNCHES['factor_ema'] += 1
    return out


# ---------------------------------------------------------------------------
# K2: conv-A patch covariance. Replaces pallas_kernels._patch_cov_kernel
# (pallas_kernels.py:319, driven by _pallas_patch_cov :372 /
# conv_a_factor_fused :485). Bound on the H100: operations (ResNet-50's
# conv A factors are 1.31 TFLOP per step at rows D (D + 1) FLOPs each, on a
# few MB of input per layer). The kernel is K1's Gram engine (gram_tc.cuh:
# 3xTF32 mma.sync over a cp.async ring, lower-triangle tile pairs, split-K,
# a fixed-order finalize that mirrors each upper entry from its lower one)
# with its own staging: the implicit im2col gathered straight from the
# input (`patch4`: the KH*KW-times-larger patch matrix never exists, and
# padding taps are zero-filled by cp.async, with no padded copy), or, for a
# 1 x 1 stride-1 unpadded conv, whose patch matrix is the input read as
# (B*H*W, C) rows, K1's row stagings. patch_cov_plan decides the staging
# path, the tile and the split.
# ---------------------------------------------------------------------------

_K2_STAGING = _K1_STAGING + ('patch4',)  # csrc kPath 0, 1, 2, 3
# A block's time per k-tile by staging ('patch4', or 'rows' for K1's row
# stagings) and tile edge, microseconds on the H100: medians over every
# ResNet-32 and ResNet-50 conv A shape of the tile sweep of
# scripts/k2_tiles.py (time / (waves x (k-tiles per chunk + 2))). patch4
# pays for its 4-byte copies, row decode and per-element tap check. K1's
# _K1_US_PER_KTILE sets K1's split at the one tile its width fixes; across
# tiles the sweep found 32- and 64-wide tiles far slower than it models.
_K2_US_PER_KTILE = {'patch4': {32: 2.18, 64: 2.48, 128: 3.81},
                    'rows': {32: 1.94, 64: 2.16, 128: 2.9}}


@dataclasses.dataclass(frozen=True)
class PatchCovPlan:
    """How K2 runs one conv input: its patch rows (``b*oh*ow``) and
    features (``c*kh*kw``), the conv's output grid and top / left padding,
    the staging path (``'patch4'``: the implicit im2col; else one of K1's,
    with K1's row geometry ``inner``, ``sb``, ``ss``, ``sc`` as in
    :class:`FactorEmaPlan`, zeros for ``patch4``), the tile edge, the
    lower-triangle tile pairs, the split-K chunks of ``rows_per_chunk``
    rows, the modelled time in microseconds and the workspace (partial
    tiles, then column sums with a bias) in bytes."""
    rows: int
    d_in: int
    oh: int
    ow: int
    ph: int
    pw: int
    path: str
    inner: int
    sb: int
    ss: int
    sc: int
    tile: int
    npairs: int
    chunks: int
    rows_per_chunk: int
    us: float
    ws_bytes: int

    @property
    def ntiles(self) -> int:
        return -(-self.d_in // self.tile)


@functools.lru_cache(maxsize=1024)
def patch_cov_plan(shape, strides, kernel_size, conv_strides, pads,
                   has_bias: bool, device_sms: int = 132,
                   aligned: bool = True) -> PatchCovPlan:
    """K2's plan for a ``(B, C, H, W)`` input of element ``strides``
    (``aligned``: its first element is 16-byte aligned) under a conv of
    ``kernel_size``, ``conv_strides`` and ``pads`` (``((top, bottom),
    (left, right))``, as :func:`_canonical_pad` gives them), on a card of
    ``device_sms`` SMs (cached: one plan per layer shape).

    A 1 x 1 stride-1 unpadded conv whose (h, w) axes collapse to one
    strided axis takes K1's staging path by K1's rule
    (:func:`_row_geometry`); every other conv takes ``patch4``. The tile
    edge, 32, 64 or 128, minimizes the modelled time of
    :func:`_gram_split` (waves of resident blocks times k-tiles per chunk
    at the path's time per k-tile, and the finalize), which counts the
    padded width: a 128-wide tile over D = 144 computes three 128 x 128
    pairs for 144 x 145 / 2 entries.
    """
    plans = [_k2_plan(tuple(shape), tuple(strides), tuple(kernel_size),
                      tuple(conv_strides), pads, has_bias, tile, device_sms,
                      aligned) for tile in _K1_BLOCKS_PER_SM]
    return min(plans, key=lambda p: p.us)


def _k2_plan(shape, strides, kernel_size, conv_strides, pads,
             has_bias: bool, tile: int, device_sms: int,
             aligned: bool) -> PatchCovPlan:
    """K2's plan with the tile edge given."""
    b, c, h, w = shape
    kh, kw = kernel_size
    sh, sw = conv_strides
    (ph, ph_hi), (pw, pw_hi) = pads
    oh = (h + ph + ph_hi - kh) // sh + 1
    ow = (w + pw + pw_hi - kw) // sw + 1
    if min(b, oh, ow) < 1:
        raise ValueError(f'patch_cov: empty conv output for input {shape}')
    rows, d_in = b * oh * ow, c * kh * kw
    inner = rsb = ss = sc = 0
    path = 'patch4'
    if ((kh, kw, sh, sw, ph, ph_hi, pw, pw_hi) == (1, 1, 1, 1, 0, 0, 0, 0)
            and not (h > 1 and w > 1 and strides[2] != w * strides[3])):
        _, _, inner, rsb, ss, sc, path = _row_geometry(shape, strides,
                                                       aligned, 'patch_cov')
    us_per_ktile = _K2_US_PER_KTILE['patch4' if path == 'patch4'
                                    else 'rows'][tile]
    ktiles = -(-rows // _ROW_STEP)
    ntiles = -(-d_in // tile)
    npairs = ntiles * (ntiles + 1) // 2
    chunks, us = _gram_split(ktiles, npairs,
                             device_sms * _K1_BLOCKS_PER_SM[tile], tile,
                             us_per_ktile, 4 * b * c * h * w)
    per = -(-ktiles // chunks) * _ROW_STEP
    chunks = -(-rows // per)
    floats = chunks * npairs * tile * tile
    if has_bias:
        floats += chunks * ntiles * tile
    return PatchCovPlan(rows, d_in, oh, ow, ph, pw, path, inner, rsb, ss,
                        sc, tile, npairs, chunks, per, us, 4 * floats)


def patch_cov_plain(x: torch.Tensor, kernel_size, strides, padding,
                    has_bias: bool, *, bf16: bool = False) -> torch.Tensor:
    """Plain version of K2: the im2col patch covariance scaled by
    ``1/(rows*spatial^2)``, with the bias row/column and corner
    ``1/spatial^2`` when ``has_bias``."""
    p = _round(extract_conv2d_patches(x, kernel_size, strides, padding),
               bf16)
    _, oh, ow = conv_out_geometry(x.shape, kernel_size, strides, padding)
    spatial = oh * ow
    inv = 1.0 / (p.shape[0] * spatial * spatial)
    colsum = p.sum(0) if has_bias else None
    return _finish_gram(p.T @ p, colsum, inv, inv,
                        1.0 / (spatial * spatial), None, 0.0)


def patch_cov(x: torch.Tensor, kernel_size, strides, padding,
              has_bias: bool, *, compute_dtype=None) -> torch.Tensor:
    """Conv A factor (K2) of a ``(B, C, H, W)`` input: dense ``(D, D)``
    fp32 (``D = C*KH*KW [+1]``) in the ``(c, kh, kw)`` basis, padding as
    :func:`_canonical_pad`. The patch matrix is never materialized. A bf16
    or fp16 ``x`` (a half-precision capture) is widened to fp32 first."""
    bf16 = mult_bf16(compute_dtype)
    if not _dispatch_device(x, 'patch_cov'):
        return patch_cov_plain(x, kernel_size, strides, padding, has_bias,
                               bf16=bf16)
    x = _widened(x)
    _require(x, 'patch_cov x', 4)
    _require_int32_offsets(x, 'patch_cov')
    kernel_size, strides = tuple(kernel_size), tuple(strides)
    pads = _canonical_pad(padding, kernel_size, tuple(x.shape[2:]), strides)
    plan = patch_cov_plan(tuple(x.shape), x.stride(), kernel_size, strides,
                          pads, bool(has_bias),
                          _sm_count(x.device.index or 0),
                          aligned=x.data_ptr() % 16 == 0)
    return _patch_cov_launch(plan, x, kernel_size, strides, bool(has_bias),
                             bf16)


def _patch_cov_launch(plan: PatchCovPlan, x: torch.Tensor, kernel_size,
                      strides, has_bias: bool, bf16: bool) -> torch.Tensor:
    """One K2 call on a checked CUDA input under ``plan``."""
    spatial = plan.oh * plan.ow
    inv = 1.0 / (plan.rows * spatial * spatial)
    n = plan.d_in + int(has_bias)
    ws = _plan_workspace(plan, x.device)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    err = _lib('patch_cov').kfac_patch_cov(
        x.data_ptr(), *x.shape, *x.stride(), *kernel_size, *strides,
        plan.ph, plan.pw, plan.oh, plan.ow, plan.inner, plan.sb, plan.ss,
        plan.sc, int(bf16), plan.tile, _K2_STAGING.index(plan.path),
        plan.chunks, plan.rows_per_chunk, ws.data_ptr(), inv,
        int(has_bias), inv, 1.0 / (spatial * spatial), out.data_ptr(),
        _stream(x))
    _check(err, 'patch_cov')
    LAUNCHES['patch_cov'] += 1
    return out


# ---------------------------------------------------------------------------
# K3: bucketed preconditioning with the KL-clip v.g partial. Replaces
# pallas_kernels._bucket_precond_kernel (pallas_kernels.py:804, driven by
# _pallas_bucket_precond :845 / fused_bucket_precondition :883). Bound on
# the H100: operations at the large buckets (ResNet-50's (512, 4608) x 3 is
# 72.5 GFLOP, three times that in TF32 products), launches at the small
# ones. A 4608 x 4608 A_inv does not fit a block's shared memory, so the
# chain is one launch per product of the batched tile GEMM of gemm_tc.cuh
# (3xTF32 mma.sync over a cp.async ring, grid z = slice; QG^T and QA^T read
# in place through the transposed stagings), with the eigenvalue divide and
# the v.g partial fused into epilogues, plus a fixed-order reduction of the
# partials. bucket_precond_plan picks the tile height and staging path.
# ---------------------------------------------------------------------------

_K3_STAGING = ('vec4', 'vec16')  # csrc `vec` 0, 1
_K3_TILE_N = 128
# Blocks per SM by tile height (shared memory and the register cap), and
# the time per 32-deep k-tile of the blocks resident on one SM, by staging
# path, tile height and resident blocks, microseconds on the H100 (tile
# sweeps of the ResNet-50 and LSTM buckets, scripts/k3_tiles.py).
_K3_BLOCKS_PER_SM = {64: 2, 128: 1}
_K3_US_PER_KTILE = {('vec16', 128, 1): 2.6, ('vec16', 64, 1): 1.9,
                    ('vec16', 64, 2): 2.8, ('vec4', 128, 1): 3.35,
                    ('vec4', 64, 1): 2.9, ('vec4', 64, 2): 4.8}


@dataclasses.dataclass(frozen=True)
class BucketPrecondPlan:
    """How K3 runs one bucket of ``s`` slices of ``(g_dim, a_dim)``
    gradients: ``tile_m`` rows of G by 128 columns of A per block, the
    staging path (``'vec16'``: 16-byte copies, ``'vec4'``: 4-byte), the
    output tiles per slice (``tiles``: also the v.g partials the last
    product writes per slice), the waves of each product's grid at the
    tile's resident blocks per SM, the modelled time per k-tile of the
    busiest SM's blocks (``us_per_ktile``, microseconds), and the
    workspace in floats (U, T for eigen, then the partials)."""
    s: int
    g_dim: int
    a_dim: int
    eigen: bool
    tile_m: int
    path: str
    tiles: int
    waves: int
    us_per_ktile: float
    ws_floats: int


@functools.lru_cache(maxsize=1024)
def bucket_precond_plan(s: int, g_dim: int, a_dim: int, eigen: bool,
                        device_sms: int = 132,
                        aligned: bool = True) -> BucketPrecondPlan:
    """K3's plan for ``s`` slices of ``(g_dim, a_dim)`` (``aligned``: every
    operand's first element is 16-byte aligned) on a card of
    ``device_sms`` SMs (cached: one plan per bucket shape).

    Every product of the chain has the ``(G, A)`` output, so one grid
    serves them all. The 16-byte staging needs G and A to be multiples of
    4 (each operand's rows then start 16-byte aligned); the others (A =
    2049, 651, 147, G = 650) stage with 4-byte copies. The tile height,
    64 or 128, minimizes the modelled time of the SM that holds the most
    blocks: at G <= 64 a 128-row tile would be half empty or worse; two
    64-row blocks share an SM where one 128-row block (140-144 KB of ring)
    holds it alone, and a 64-row block alone on an SM runs faster still,
    so 64 rows win where they spread a grid over more SMs and 128 where
    they fill the card. The (512, 4608) x 3 bucket, for one, gives 432
    128-row tiles, 3.3 waves at one block per SM, and 864 64-row tiles,
    3.3 waves at two.
    """
    if min(s, g_dim, a_dim) < 1:
        raise ValueError(f'bucket_precond_plan: empty bucket ({s}, {g_dim}, '
                         f'{a_dim})')
    path = ('vec16' if aligned and g_dim % 4 == 0 and a_dim % 4 == 0
            else 'vec4')
    plans = [_k3_plan(s, g_dim, a_dim, eigen, path, tile_m, device_sms)
             for tile_m in _K3_BLOCKS_PER_SM]
    return min(plans, key=lambda p: p.us_per_ktile)


def _k3_plan(s: int, g_dim: int, a_dim: int, eigen: bool, path: str,
             tile_m: int, device_sms: int) -> BucketPrecondPlan:
    """K3's plan with the tile height and staging path given."""
    tiles = -(-g_dim // tile_m) * -(-a_dim // _K3_TILE_N)
    per_sm = _K3_BLOCKS_PER_SM[tile_m]
    waves = -(-s * tiles // (device_sms * per_sm))
    # The busiest SM runs `most` blocks, `per_sm` at a time.
    most = -(-s * tiles // device_sms)
    us = (most // per_sm * _K3_US_PER_KTILE[path, tile_m, per_sm]
          + (_K3_US_PER_KTILE[path, tile_m, 1] if most % per_sm else 0.0))
    ws_floats = s * (g_dim * a_dim * (2 if eigen else 1) + tiles)
    return BucketPrecondPlan(s, g_dim, a_dim, bool(eigen), tile_m, path,
                             tiles, waves, us, ws_floats)


def _bucket_precond_workspace(plan: BucketPrecondPlan, device):
    """One flat allocation of ``plan.ws_floats``: U ``(s, G, A)``, then T
    for eigen, then the ``(s, tiles)`` v.g partials, at the element
    offsets ``(0, n, (1 + eigen) n)`` (n = s G A) that
    :func:`_bucket_precond_launch` hands the library as pointers (views
    cost host time, which the small buckets feel)."""
    n = plan.s * plan.g_dim * plan.a_dim
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=device)
    return ws, (0, n, (2 if plan.eigen else 1) * n)


def bucket_precond_plain(gstack: torch.Tensor, entry: dict, damping, *,
                         bf16: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3, in the kernel's association order: eigen
    ``U = g QA``, ``T = (QG^T U) / (dG dA^T + lambda)``, ``W = T QA^T``,
    ``v = QG W``; baked ``v = G_inv (g A_inv)``; ``vg = sum(v * g)``.
    bf16 stacks are read widened."""
    r = lambda t: _round(t, bf16)  # noqa: E731
    g = gstack.float()
    if 'QA' in entry:
        qa, qg = r(entry['QA']), r(entry['QG'])
        u = r(g) @ qa
        t = (qg.transpose(-1, -2) @ r(u)) / (
            entry['dG'].float()[:, :, None] * entry['dA'].float()[:, None, :]
            + damping)
        v = qg @ r(r(t) @ qa.transpose(-1, -2))
    else:
        v = r(entry['G_inv']) @ r(r(g) @ r(entry['A_inv']))
    return v, (v * g).sum(dim=(1, 2))


def bucket_precond(gstack: torch.Tensor, entry: dict, damping, *,
                   compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed preconditioning (K3) of an ``(S, G, A)`` gradient stack.

    ``entry`` holds stacked full-rank eigen slots ``{'QA', 'dA', 'QG',
    'dG'}`` or baked inverses ``{'A_inv', 'G_inv'}``, fp32 or bf16 (bf16
    inverse storage: widened to fp32 before the launch, as the JAX wrapper
    widens them before its Pallas call; a half-precision ``gstack`` is
    widened alike). Returns ``(v, vg)``: the ``(S, G,
    A)`` preconditioned stack and the ``(S,)`` per-slice ``sum(v * g)``
    KL-clip partials (before the caller's ``lr^2``).
    """
    bf16 = mult_bf16(compute_dtype)
    if not _dispatch_device(gstack, 'bucket_precond'):
        return bucket_precond_plain(gstack, entry, damping, bf16=bf16)
    entry = {k: _widened(t) for k, t in entry.items()}
    gstack = _widened(gstack)
    _require(gstack, 'bucket_precond g', 3)
    s, g_dim, a_dim = gstack.shape
    eigen = 'QA' in entry
    shapes = ({'QA': (s, a_dim, a_dim), 'QG': (s, g_dim, g_dim),
               'dA': (s, a_dim), 'dG': (s, g_dim)} if eigen
              else {'A_inv': (s, a_dim, a_dim), 'G_inv': (s, g_dim, g_dim)})
    for key, shape in (('g', tuple(gstack.shape)), *shapes.items()):
        t = gstack if key == 'g' else entry[key]
        _require(t, f'bucket_precond {key}')
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f'bucket_precond: {key} must be a contiguous '
                             f'{shape} tensor, got {tuple(t.shape)}')
    plan = bucket_precond_plan(
        s, g_dim, a_dim, eigen, _sm_count(gstack.device.index or 0),
        aligned=all(t.data_ptr() % 16 == 0
                    for t in (gstack, *(entry[k] for k in shapes))))
    return _bucket_precond_launch(plan, gstack, entry, damping, bf16)


def _bucket_precond_launch(plan: BucketPrecondPlan, gstack: torch.Tensor,
                           entry: dict, damping, bf16: bool
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One K3 call on checked CUDA inputs under ``plan``."""
    lib = _lib('bucket_precond')
    ws, offsets = _bucket_precond_workspace(plan, gstack.device)
    ws_u, ws_t, vg_part = (ws.data_ptr() + 4 * o for o in offsets)
    v = torch.empty_like(gstack)
    vg = torch.empty((plan.s,), dtype=torch.float32, device=gstack.device)
    geometry = (plan.s, plan.g_dim, plan.a_dim, plan.tile_m,
                _K3_STAGING.index(plan.path), int(bf16))
    if plan.eigen:
        err = lib.kfac_bucket_precond_eigen(
            gstack.data_ptr(), entry['QA'].data_ptr(),
            entry['QG'].data_ptr(), entry['dA'].data_ptr(),
            entry['dG'].data_ptr(), float(damping), *geometry, ws_u, ws_t,
            vg_part, v.data_ptr(), vg.data_ptr(), _stream(gstack))
    else:
        err = lib.kfac_bucket_precond_baked(
            gstack.data_ptr(), entry['A_inv'].data_ptr(),
            entry['G_inv'].data_ptr(), *geometry, ws_u, vg_part,
            v.data_ptr(), vg.data_ptr(), _stream(gstack))
    _check(err, 'bucket_precond')
    LAUNCHES['bucket_precond'] += 1
    return v, vg


# ---------------------------------------------------------------------------
# K4: batched damped SPD inverse by Newton--Schulz. Replaces
# pallas_kernels._ns_inverse_kernel (driven by _pallas_batched_ns_inverse /
# batched_inverse / damped_inverse_stack). The TPU kernel keeps M and X in
# VMEM (n <= 512); here every n runs as two launches per iteration of the
# batched 128 x 128-tile tensor-core GEMM of gemm_tc.cuh (mma.sync TF32,
# 32-deep k-tiles through a 4-slot cp.async ring in dynamic shared memory,
# fp32 accumulators) with fused epilogues (the residual max; 2X - XY into a
# second buffer), per-matrix active flags in device memory, and one host
# read of the active count every 8 iterations. Each fp32 product is three
# TF32 products (3xTF32: big and small parts), so the bound on the H100 is
# 3 x 4 n^3 FLOPs per matrix and iteration at the dense TF32 rate of 494.7
# TFLOP/s. Plain TF32 is not used: the reference iterates at
# Precision.HIGHEST, and one TF32 product stalls the residual near 2e-3,
# far above tol. It follows the unpadded iteration: no identity padding,
# no size cap.
# ---------------------------------------------------------------------------

def batched_inverse_plain(mats: torch.Tensor, damping, iters: int = 100,
                          tol: float = 1e-5
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: :func:`linalg.newton_schulz_inverse` of each
    matrix of a ``(B, n, n)`` stack. Returns ``(inverses, iterations run
    per matrix)``."""
    return linalg.newton_schulz_inverse(mats, damping, iters=iters, tol=tol,
                                        with_iters=True)


def batched_inverse(mats: torch.Tensor, damping, iters: int = 100,
                    tol: float = 1e-5, *, with_iters: bool = False):
    """Damped inverses ``(F + damping I)^-1`` of a ``(B, n, n)`` fp32 SPD
    stack by Newton--Schulz (K4), each matrix stopping on its own once
    ``max|M X - I| <= tol`` or after ``iters`` iterations. With
    ``with_iters`` also returns the ``(B,)`` int32 iterations run per
    matrix."""
    damping = 0.0 if damping is None else float(damping)
    if not _dispatch_device(mats, 'batched_inverse'):
        out, k = batched_inverse_plain(mats, damping, iters, tol)
        return (out, k) if with_iters else out
    _require(mats, 'batched_inverse mats', 3)
    b, n, n2 = mats.shape
    if n != n2 or not mats.is_contiguous() or b < 1 or n < 1:
        raise ValueError(f'batched_inverse: expected a contiguous (B, n, n) '
                         f'stack, got shape {tuple(mats.shape)}')
    if b > 65535:
        raise ValueError(f'batched_inverse: at most 65535 matrices per '
                         f'launch (grid z), got {b}')
    iters = int(iters)
    if iters < 0:
        raise ValueError(f'batched_inverse: iters must be >= 0, got {iters}')
    dev = mats.device
    out = torch.empty_like(mats)
    m_ws, y_ws, x_ws = (torch.empty_like(mats) for _ in range(3))
    fstate = torch.empty((b * (1 + iters),), dtype=torch.float32,
                         device=dev)
    istate = torch.empty((3 * b + 1,), dtype=torch.int32, device=dev)
    err = _lib('ns_inverse').kfac_ns_inverse(
        mats.data_ptr(), damping, b, n, iters, float(tol), m_ws.data_ptr(),
        y_ws.data_ptr(), x_ws.data_ptr(), fstate.data_ptr(),
        istate.data_ptr(), out.data_ptr(), _stream(mats))
    _check(err, 'batched_inverse')
    LAUNCHES['ns_inverse'] += 1
    return (out, istate[b:2 * b]) if with_iters else out


def damped_inverse_stack(stack: torch.Tensor, damping, method: str,
                         iters: int = 100) -> torch.Tensor:
    """Damped inverses of a same-size factor stack: ``'newton'`` runs K4
    (:func:`batched_inverse`), ``'cholesky'`` the batched Cholesky
    inverse (:func:`linalg.get_inverse`)."""
    if method == 'newton':
        with profiling.annotate('kfac/inverse/newton'):
            return batched_inverse(stack, damping, iters=iters)
    if method == 'cholesky':
        return linalg.get_inverse(stack, damping)
    raise ValueError(f"damped inverse method must be 'newton' or "
                     f"'cholesky', got {method!r}")


# ---------------------------------------------------------------------------
# K5: batched Brent--Luk parallel Jacobi eigh. Replaces
# pallas_kernels._jacobi_eigh_kernel (driven by _pallas_batched_jacobi_eigh /
# batched_jacobi_eigh). Bound on the H100: operations -- 9 n^2 fp32 FLOPs per
# matrix and round over sweeps * (n - 1) rounds (~7.7 ms for a (16, 652)
# stack at the fp32 peak). The TPU kernel holds A and V in VMEM for every
# round. Here, for n_pad up to the capacity of an 8-CTA cluster (664), one
# thread-block cluster per matrix holds A in its distributed shared memory
# for all rounds of one launch and logs each round's (c, s); a second
# kernel applies the log to row blocks of V (see csrc/jacobi_eigh.cu).
# Larger n runs the streaming kernel: one launch per round, A and V through
# L2 / HBM. The path is chosen by size alone. Pad, sort and strip stay
# outside the kernels, as in JAX.
# ---------------------------------------------------------------------------

#: Working-set budget of one chunk of matrices on the streaming path (4
#: buffers of n_pad^2 floats each), so that a chunk's rounds run in L2.
_JACOBI_L2_BYTES = 32 << 20
#: Opt-in dynamic shared memory of one block and shared memory of one SM on
#: the H100, and what is kept back from the block's share for the kernels'
#: static shared variables.
_SMEM_PER_BLOCK = 232448
_SMEM_PER_SM = 233472
_SMEM_RESERVE = 1024
_SMS = 132
#: Cluster sizes of the A kernel (8 is the portable maximum).
_JACOBI_CLUSTERS = (1, 2, 4, 8)
#: Budget of the rotation log of one chunk of matrices.
_JACOBI_LOG_BYTES = 1 << 30


def jacobi_slot_dest(n_pad: int) -> torch.Tensor:
    """The Brent--Luk exchange as an int32 table: slot ``k`` moves to slot
    ``dest[k]`` (:func:`linalg.jacobi_exchange`; the identity for
    ``n_pad = 2``, where the plain loop skips the exchange)."""
    if n_pad <= 2:
        return torch.arange(n_pad, dtype=torch.int32)
    moved = linalg.jacobi_exchange(torch.arange(n_pad), 0)
    dest = torch.empty(n_pad, dtype=torch.int32)
    dest[moved] = torch.arange(n_pad, dtype=torch.int32)
    return dest


def jacobi_ring_order(n_pad: int) -> torch.Tensor:
    """The exchange as a ring: the slot at each of the ``n_pad - 1`` ring
    positions, starting at slot 1 and following :func:`jacobi_slot_dest`
    (``t1 .. t_{p-1}, b_{p-1} .. b0``). Slot 0 never moves; every other
    slot's content moves one ring position forward per exchange, so after
    ``r`` exchanges slot ``ring[q]`` holds what slot ``ring[(q - r) mod
    (n_pad - 1)]`` held at the start."""
    dest = jacobi_slot_dest(n_pad).tolist()
    ring = [1]
    for _ in range(n_pad - 2):
        ring.append(dest[ring[-1]])
    if sorted(ring) != list(range(1, n_pad)):
        raise AssertionError(f'exchange of size {n_pad} is not one ring')
    return torch.tensor(ring, dtype=torch.int32)


def jacobi_ring_position(n_pad: int) -> torch.Tensor:
    """The kernels' table: each slot's position in
    :func:`jacobi_ring_order`, -1 for slot 0."""
    pos = torch.full((n_pad,), -1, dtype=torch.int32)
    pos[jacobi_ring_order(n_pad).long()] = torch.arange(
        n_pad - 1, dtype=torch.int32)
    return pos


def jacobi_cluster_bytes(n_pad: int, cluster: int) -> int:
    """Dynamic shared memory of one CTA of the cluster kernel (must match
    ``csrc/jacobi_eigh.cu``): ``2 ceil(p / C) + 2`` columns of ``n_pad``
    floats (its pairs' columns and two staging columns), the ``p`` pairs'
    ``(c, s)``, its column table and two incoming column indices."""
    p = n_pad // 2
    nl = -(-p // cluster)
    return 4 * (2 * nl + 2) * n_pad + 8 * p + 4 * (2 * nl + 4)


@dataclasses.dataclass(frozen=True)
class JacobiClusterPlan:
    """Launch geometry of the cluster path of K5 for one stack."""
    cluster: int         # CTAs per matrix (cluster size)
    pairs_per_cta: int   # at most; the pairs are split as evenly as can be
    smem_bytes: int      # dynamic shared memory per CTA of the A kernel
    v_rows: int          # rows of V per CTA of the V kernel
    v_smem_bytes: int    # dynamic shared memory per CTA of the V kernel
    chunk: int           # matrices per launch pair
    log_bytes: int       # rotation log of one chunk


def jacobi_cluster_plan(n_pad: int, batch: int, rounds: int
                        ) -> JacobiClusterPlan | None:
    """The cluster path's geometry for ``batch`` matrices of even size
    ``n_pad`` over ``rounds`` rounds, or ``None`` where no cluster size
    holds a matrix (the streaming path).

    The cluster size is the smallest of 1, 2, 4, 8 whose per-CTA bytes fit
    the block's shared memory less a reserve (and that leaves every CTA at
    least two pairs); the chunk keeps the log (``rounds * p`` float pairs
    per matrix) within ``_JACOBI_LOG_BYTES``; the V kernel's rows per CTA
    give about two CTAs per SM over the chunk, two CTAs fitting one SM.
    """
    if n_pad < 2 or n_pad % 2 or batch < 1 or rounds < 0:
        raise ValueError(f'jacobi_cluster_plan: need an even n_pad >= 2, '
                         f'batch >= 1 and rounds >= 0, got {n_pad}, {batch}, '
                         f'{rounds}')
    p = n_pad // 2
    fits = [c for c in _JACOBI_CLUSTERS if (c == 1 or p >= 2 * c) and
            jacobi_cluster_bytes(n_pad, c) <= _SMEM_PER_BLOCK - _SMEM_RESERVE]
    if not fits:
        return None
    cluster = fits[0]
    per_matrix = 8 * max(1, rounds) * p
    chunk = max(1, min(batch, 65535, _JACOBI_LOG_BYTES // per_matrix))
    per_sm = max(1, 2 * _SMS // chunk)
    max_rows = (_SMEM_PER_SM // 2 - _SMEM_RESERVE - 16 * p) // (4 * n_pad)
    v_rows = max(1, min(-(-n_pad // per_sm), max_rows))
    return JacobiClusterPlan(
        cluster=cluster, pairs_per_cta=-(-p // cluster),
        smem_bytes=jacobi_cluster_bytes(n_pad, cluster), v_rows=v_rows,
        v_smem_bytes=4 * v_rows * n_pad + 16 * p, chunk=chunk,
        log_bytes=chunk * per_matrix)


def jacobi_cluster_capacity() -> int:
    """The largest even ``n_pad`` the cluster path takes."""
    n_pad = 2
    while jacobi_cluster_plan(n_pad + 2, 1, 1) is not None:
        n_pad += 2
    return n_pad


@functools.lru_cache(maxsize=None)
def _jacobi_table_on(table, n_pad: int, device: torch.device
                     ) -> torch.Tensor:
    """``table(n_pad)`` on the card, built once per size (the kernels only
    read it)."""
    return table(n_pad).to(device)


def jacobi_max_active_clusters(n_pad: int) -> int:
    """How many clusters of the A kernel for ``n_pad`` the card holds at
    once (``cudaOccupancyMaxActiveClusters``); needs the card."""
    plan = jacobi_cluster_plan(n_pad, 1, 1)
    if plan is None:
        raise ValueError(f'n_pad {n_pad} runs the streaming path')
    out = ctypes.c_int(0)
    _check(_lib('jacobi_eigh').kfac_jacobi_cluster_occupancy(
        n_pad, plan.cluster, ctypes.byref(out)), 'jacobi_max_active_clusters')
    return out.value


def batched_jacobi_eigh_plain(mats: torch.Tensor, sweeps: int | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: :func:`linalg.jacobi_eigh` of each matrix of a
    ``(B, n, n)`` stack; ``(Q, d)`` ascending."""
    return linalg.jacobi_eigh(mats, sweeps)


def batched_jacobi_eigh(mats: torch.Tensor, sweeps: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition of a ``(B, n, n)`` fp32 stack by
    Brent--Luk parallel Jacobi (K5): ``(Q, d)`` with eigenvalues
    ascending, ``sweeps`` defaulting to
    :func:`linalg.default_jacobi_sweeps` of ``n``.

    Odd ``n`` is padded with a decoupled unit eigenpair, and the result
    sorted and stripped of it, around the kernels; ``n = 1`` launches
    nothing. Up to the cluster capacity (:func:`jacobi_cluster_plan`) each
    chunk of matrices is one launch of the cluster kernel and one of the
    V kernel, with the rotation log from torch's allocator; above it, one
    launch per round covers as many matrices as fit the L2 budget.
    """
    n = mats.shape[-1]
    if sweeps is None:
        sweeps = linalg.default_jacobi_sweeps(n)
    if not _dispatch_device(mats, 'batched_jacobi_eigh'):
        return batched_jacobi_eigh_plain(mats, sweeps)
    _require(mats, 'batched_jacobi_eigh mats', 3)
    b, n, n2 = mats.shape
    if n != n2 or not mats.is_contiguous() or b < 1 or n < 1:
        raise ValueError(f'batched_jacobi_eigh: expected a contiguous '
                         f'(B, n, n) stack, got shape {tuple(mats.shape)}')
    sweeps = int(sweeps)
    if sweeps < 0:
        raise ValueError(f'batched_jacobi_eigh: sweeps must be >= 0, got '
                         f'{sweeps}')
    if n == 1:
        return torch.ones_like(mats), mats.reshape(b, 1).clone()
    a0, v0 = linalg.jacobi_pad(mats)
    n_pad = a0.shape[-1]
    rounds = sweeps * (n_pad - 1)
    lib = _lib('jacobi_eigh')
    plan = jacobi_cluster_plan(n_pad, b, rounds)
    if plan is None:
        # Matrices per launch: as many as fit the L2 budget, at most grid z.
        chunk = max(1, min(b, 65535,
                           _JACOBI_L2_BYTES // (16 * n_pad * n_pad)))
        a1, v1 = torch.empty_like(a0), torch.empty_like(v0)
        dest = _jacobi_table_on(jacobi_slot_dest, n_pad, mats.device)
        err = lib.kfac_jacobi_eigh(
            a0.data_ptr(), a1.data_ptr(), v0.data_ptr(), v1.data_ptr(),
            dest.data_ptr(), b, n_pad, rounds, chunk, _stream(mats))
        _check(err, 'batched_jacobi_eigh')
        LAUNCHES['jacobi_eigh'] += 1
        a, v = (a0, v0) if rounds % 2 == 0 else (a1, v1)
        return linalg.jacobi_finish(torch.diagonal(a, dim1=-2, dim2=-1), v,
                                    n)
    # The V kernel writes every entry of v0, so the identity start is its
    # output buffer.
    d = a0.new_empty((b, n_pad))
    log = torch.empty(plan.log_bytes // 4, dtype=torch.float32,
                      device=mats.device)
    pos = _jacobi_table_on(jacobi_ring_position, n_pad, mats.device)
    for z0 in range(0, b, plan.chunk):
        count = min(plan.chunk, b - z0)
        err = lib.kfac_jacobi_eigh_cluster(
            a0[z0].data_ptr(), d[z0].data_ptr(), v0[z0].data_ptr(),
            log.data_ptr(), pos.data_ptr(), count, n_pad, rounds,
            plan.cluster, plan.v_rows, _stream(mats))
        _check(err, 'batched_jacobi_eigh')
    LAUNCHES['jacobi_eigh'] += 1
    return linalg.jacobi_finish(d, v0, n)


#: Per kernel: its source, the TPU kernel it replaces, and what bounds it.
KERNEL_INFO = {
    'factor_ema': {
        'source': 'distributed_kfac_pytorch_tpu_torch/csrc/factor_ema.cu',
        'replaces': 'distributed_kfac_pytorch_tpu/ops/pallas_kernels.py:661',
    },
    'patch_cov': {
        'source': 'distributed_kfac_pytorch_tpu_torch/csrc/patch_cov.cu',
        'replaces': 'distributed_kfac_pytorch_tpu/ops/pallas_kernels.py:372',
    },
    'bucket_precond': {
        'source':
            'distributed_kfac_pytorch_tpu_torch/csrc/bucket_precond.cu',
        'replaces': 'distributed_kfac_pytorch_tpu/ops/pallas_kernels.py:845',
    },
    'ns_inverse': {
        'source': 'distributed_kfac_pytorch_tpu_torch/csrc/ns_inverse.cu',
        'replaces': 'distributed_kfac_pytorch_tpu/ops/pallas_kernels.py:122',
    },
    'jacobi_eigh': {
        'source': 'distributed_kfac_pytorch_tpu_torch/csrc/jacobi_eigh.cu',
        'replaces': 'distributed_kfac_pytorch_tpu/ops/pallas_kernels.py:210',
    },
}

__all__ = ['LAUNCHES', 'KERNEL_INFO', 'reset_launches', 'build',
           'drain_build_events',
           'factor_ema', 'factor_ema_plain', 'factor_ema_plan',
           'FactorEmaPlan', 'patch_cov', 'patch_cov_plain', 'patch_cov_plan',
           'PatchCovPlan',
           'bucket_precond', 'bucket_precond_plain', 'bucket_precond_plan',
           'BucketPrecondPlan', 'batched_inverse',
           'batched_inverse_plain', 'damped_inverse_stack',
           'batched_jacobi_eigh', 'batched_jacobi_eigh_plain',
           'jacobi_slot_dest', 'jacobi_ring_order', 'jacobi_ring_position',
           'jacobi_cluster_plan', 'jacobi_cluster_capacity',
           'jacobi_max_active_clusters', 'JacobiClusterPlan', 'mult_bf16',
           'extract_conv2d_patches', 'conv_out_geometry']
