#!/usr/bin/env python3
"""Ablations of the K4 kernel (Newton--Schulz inverse) on one H100.

    python3 scripts/k4_ablation.py     # needs one CUDA device and nvcc

Builds the committed K4 (``csrc/ns_inverse.cu`` with ``csrc/gemm_tc.cuh``)
and variants of it, each a text edit of the committed sources, and times
them in turns (forward, then backward order) on random SPD stacks at the
large ResNet-50 buckets of ``chip_smoke.py`` phase 4, damping 0.001. Beside
each time: the iterations run, ``max|MX - I|`` and the relative Frobenius
distance to the plain version. Variants:

  committed   the kernel as it is;
  cvt_rna     both parts of the 3xTF32 split by ``cvt.rna.tf32.f32``;
  one_level   no two-level sum: the tensor cores accumulate over all of K;
  stages3     a 3-slot ``cp.async`` ring instead of 4;
  mma_only    no split: operands passed as their fp32 bits, small parts
              zero (1xTF32 results, so it runs to the cap; ms/iteration is
              the time of the three ``mma.sync`` per product alone).

Prints a line per bucket and writes ``chiprun_out/k4_ablation.json``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SPLIT = '''  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;'''
VARIANTS = {
    'committed': [],
    'cvt_rna': [(SPLIT, '''  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));''')],
    'one_level': [('mma_tf32(part[i][j]', 'mma_tf32(acc[i][j]'),
                  ('acc[i][j][e] += part[i][j][e];', ';')],
    'stages3': [('constexpr int kTcStages = 4;',
                 'constexpr int kTcStages = 3;')],
    'mma_only': [(SPLIT, '''  big = __float_as_uint(x);
  small = 0u;''')],
}
# (n, matrices, shift): the identity-shifted form above n = 1024, as in
# chip_smoke.check_ns_inverse.
CASES = ((4608, 3, 1.0), (2304, 6, 1.0), (1024, 14, 0.0), (512, 19, 0.0))
DAMPING = 0.001


def edited_sources(csrc: Path, name: str) -> dict[str, str]:
    """The K4 sources of variant ``name``: the committed ones with the
    variant's edits applied. Raises if an edit matches nothing."""
    srcs = {f: (csrc / f).read_text() for f in ('gemm_tc.cuh',
                                                 'ns_inverse.cu')}
    for old, new in VARIANTS[name]:
        if not any(old in text for text in srcs.values()):
            raise RuntimeError(f'{name}: edit {old!r} matches nothing')
        srcs = {f: text.replace(old, new) for f, text in srcs.items()}
    return srcs


def build(kernels) -> dict:
    """One shared library per variant, nvcc runs started together."""
    out = kernels.BUILD_DIR / 'ablation'
    procs = {}
    for name in VARIANTS:
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kernels.CSRC, d)
        for fname, text in edited_sources(kernels.CSRC, name).items():
            (d / fname).write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, '-I', str(d), '-o',
               str(d / 'lib.so'), str(d / 'ns_inverse.cu')]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'{name}: nvcc exit {proc.returncode}\n{log}')
        lib = ctypes.CDLL(str(out / name / 'lib.so'))
        lib.kfac_ns_inverse.argtypes = (
            kernels._SIGNATURES['ns_inverse']['kfac_ns_inverse'])
        lib.kfac_ns_inverse.restype = ctypes.c_int
        libs[name] = lib
    return libs


def run(lib, mats, iters: int = 100, tol: float = 1e-5):
    """The body of ``kernels.batched_inverse`` on another library."""
    import torch
    b = mats.shape[0]
    out = torch.empty_like(mats)
    m_ws, y_ws, x_ws = (torch.empty_like(mats) for _ in range(3))
    fstate = torch.empty((b * (1 + iters),), dtype=torch.float32,
                         device=mats.device)
    istate = torch.empty((3 * b + 1,), dtype=torch.int32, device=mats.device)
    err = lib.kfac_ns_inverse(
        mats.data_ptr(), DAMPING, b, mats.shape[-1], iters, tol,
        m_ws.data_ptr(), y_ws.data_ptr(), x_ws.data_ptr(), fstate.data_ptr(),
        istate.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'kfac_ns_inverse: CUDA error {err}')
    return out, istate[b:2 * b]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('k4_ablation: no CUDA device available', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from distributed_kfac_pytorch_tpu_torch import set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.ops import kernels

    set_fp32_precision()
    card = cs.card_line()
    print(card, flush=True)
    libs = build(kernels)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(1)
    rows = []
    for n, count, shift in CASES:
        f = cs._spd_stack(gen, count, n, shift=shift)
        ref, k_ref = kernels.batched_inverse_plain(f, DAMPING)
        row = {'n': n, 'count': count, 'plain_iters': max(k_ref.tolist()),
               'plain_residual': cs._ns_residual(f, DAMPING, ref)}
        for name, lib in libs.items():
            got, k = run(lib, f)
            row[name] = {
                'iters': max(k.tolist()),
                'residual': cs._ns_residual(f, DAMPING, got),
                'rel_fro': float(torch.linalg.norm(got - ref)
                                 / torch.linalg.norm(ref)),
                'ms': []}
        reps = (1, 3, 1) if n >= 1024 else (5, 5, 3)
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                row[name]['ms'].append(cs.time_ms(
                    lambda: run(libs[name], f), *reps))
        msg = (f'({count},{n}) plain: {row["plain_iters"]} iterations, '
               f'residual {row["plain_residual"]:.2e}')
        for name in libs:
            v = row[name]
            ms = min(v['ms'])
            msg += (f'\n  {name:10s} {ms:9.3f} ms ({ms / v["iters"]:.4f} '
                    f'per iteration; {v["ms"]}) iterations {v["iters"]} '
                    f'residual {v["residual"]:.2e} rel fro '
                    f'{v["rel_fro"]:.2e}')
        print(msg, flush=True)
        rows.append(row)
        del f, ref
    out_dir = ROOT / 'chiprun_out'
    out_dir.mkdir(exist_ok=True)
    (out_dir / 'k4_ablation.json').write_text(
        json.dumps({'card': card, 'rows': rows}, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
