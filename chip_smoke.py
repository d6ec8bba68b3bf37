#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch / CUDA port (one NVIDIA H100).

    python3 chip_smoke.py            # everything; needs one CUDA device

Phases (any failure exits nonzero and prints no result line):

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, the TF32 flags;
  2. build: every kernel from ``distributed_kfac_pytorch_tpu_torch/csrc``
     with nvcc for sm_90a (``ops.kernels.build``);
  3. kernels: each kernel at the shapes of the ResNet-32 / batch-128 main
     path plus ragged edge cases, fp32 and bf16-multiplicand modes, held
     against its plain PyTorch version on the same inputs on the card
     (relative to the largest plain entry: fp32 <= 1e-5 for the Gram
     kernels, <= 1e-4 for bucketed preconditioning; bf16 <= 1e-2), and
     timed with CUDA events (median) beside the plain version, a library
     yardstick and the card's bound;
  4. main path: ``train_cifar10_resnet.train`` on ResNet-32, batch 128,
     30 K-FAC steps on one fixed synthetic batch; every loss finite, the
     last five below the first five, and every kernel launched exactly
     as often as the path needs (factor_ema 33, patch_cov 31,
     bucket_precond 7 per step);
  5. the result: a JSON line of per-kernel numbers, then
     ``{"ok": true, "device": {...}}`` as the last line.

``--quick`` builds with ``-Xptxas -v`` and runs only the correctness
checks of phase 3 (a first call after a kernel change). ``--profile``
adds a torch.profiler pass over steady main-path steps (device time by
kernel category, the device's busy share). Details of every case go to
``chiprun_out/chip_smoke.json`` next to this script.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL_FP32 = {'factor_ema': 1e-5, 'patch_cov': 1e-5, 'bucket_precond': 1e-4}
TOL_BF16 = 1e-2
STEPS = 30
EXPECTED_PER_STEP = {'factor_ema': 33, 'patch_cov': 31, 'bucket_precond': 7}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Median over ``trials`` of the mean ms per call of ``reps`` calls,
    CUDA events around each trial, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


# ---------------------------------------------------------------------------
# Cases: (label, per-step count on the main path or 0 for an edge case,
# builder of (kernel_fn(bf16), plain_fn(bf16), library_fn, nbytes, flops))
# ---------------------------------------------------------------------------

def factor_ema_cases(gen, dev):
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K

    def case(shape, has_bias, channels_last=False):
        x = torch.randn(shape, generator=gen, device=dev)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        if x.ndim == 4:
            b, c, h, w = x.shape
            rows, d_in = b * h * w, c
            scale = float(rows) * (h * w) ** 2
        else:
            rows, d_in = x.shape
            scale = float(rows)
        n = d_in + int(has_bias)
        m = torch.randn((n, n), generator=gen, device=dev) * 0.01
        old = (torch.eye(n, device=dev) + m + m.T).contiguous()
        x2 = K._gram_rows(x).contiguous()
        old_in = old[:d_in, :d_in].contiguous()   # yardstick: no bias row
        decay = 0.95

        # Checked in both forms: with the EMA as the main path runs it,
        # and contraction-only, where the Gram is not swamped by ``old``
        # (conv G's 1/(rows*spatial^2) scale makes the blended term tiny).
        def kern(bf16, both=True):
            cdt = torch.bfloat16 if bf16 else None
            ema = K.factor_ema(x, old, decay, scale=scale,
                               has_bias=has_bias, compute_dtype=cdt)
            if not both:
                return ema
            return ema, K.factor_ema(x, None, 0.0, scale=scale,
                                     has_bias=has_bias, compute_dtype=cdt)

        def plain(bf16, both=True):
            ema = K.factor_ema_plain(x, old, decay, scale=scale,
                                     has_bias=has_bias, bf16=bf16)
            if not both:
                return ema
            return ema, K.factor_ema_plain(x, None, 0.0, scale=scale,
                                           has_bias=has_bias, bf16=bf16)

        def library():
            return torch.addmm(old_in, x2.T, x2, beta=decay,
                               alpha=(1 - decay) / scale)

        nbytes = 4 * (rows * d_in + 2 * n * n)
        return kern, plain, library, nbytes, rows * d_in * (d_in + 1)

    return [
        ('conv G (128,16,32,32)', 11, lambda: case((128, 16, 32, 32), False)),
        ('conv G (128,32,16,16)', 10, lambda: case((128, 32, 16, 16), False)),
        ('conv G (128,64,8,8)', 10, lambda: case((128, 64, 8, 8), False)),
        ('linear A (128,64)+bias', 1, lambda: case((128, 64), True)),
        ('linear G (128,10)', 1, lambda: case((128, 10), False)),
        ('ragged (1000,65)+bias', 0, lambda: case((1000, 65), True)),
        ('ragged (37,5)', 0, lambda: case((37, 5), False)),
        ('channels-last conv G (8,24,7,7)', 0,
         lambda: case((8, 24, 7, 7), False, channels_last=True)),
    ]


def patch_cov_cases(gen, dev):
    import torch
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K

    def case(shape, stride, padding, has_bias=False, channels_last=False):
        x = torch.randn(shape, generator=gen, device=dev)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        k = (3, 3)
        (pads, oh, ow) = K.conv_out_geometry(x.shape, k, stride, padding)
        (ph_lo, ph_hi), (pw_lo, pw_hi) = pads
        b, c = shape[:2]
        rows, d = b * oh * ow, c * 9
        n = d + int(has_bias)

        def kern(bf16, both=True):
            return K.patch_cov(x, k, stride, padding, has_bias,
                               compute_dtype=torch.bfloat16 if bf16
                               else None)

        def plain(bf16, both=True):
            return K.patch_cov_plain(x, k, stride, padding, has_bias,
                                     bf16=bf16)

        def library():
            # im2col rows in the (c, kh, kw) basis, then one GEMM.
            xp = F.pad(x, (pw_lo, pw_hi, ph_lo, ph_hi))
            p = F.unfold(xp, k, stride=stride).transpose(1, 2).reshape(-1, d)
            return p.T @ p

        nbytes = 4 * (x.numel() + n * n)
        return kern, plain, library, nbytes, rows * d * (d + 1)

    s1, s2 = (1, 1), (2, 2)
    return [
        ('stem D=27 (128,3,32,32)', 1, lambda: case((128, 3, 32, 32), s1, 1)),
        ('D=144 (128,16,32,32)', 10, lambda: case((128, 16, 32, 32), s1, 1)),
        ('D=144 stride 2 (128,16,32,32)', 1,
         lambda: case((128, 16, 32, 32), s2, 1)),
        ('D=288 (128,32,16,16)', 9, lambda: case((128, 32, 16, 16), s1, 1)),
        ('D=288 stride 2 (128,32,16,16)', 1,
         lambda: case((128, 32, 16, 16), s2, 1)),
        ('D=576 (128,64,8,8)', 9, lambda: case((128, 64, 8, 8), s1, 1)),
        ('SAME stride 2 +bias (7,3,9,9)', 0,
         lambda: case((7, 3, 9, 9), s2, 'SAME', has_bias=True)),
        ('channels-last (5,4,6,6)', 0,
         lambda: case((5, 4, 6, 6), s1, 1, channels_last=True)),
    ]


def bucket_precond_cases(gen, dev):
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K

    def orth(s, n):
        q, _ = torch.linalg.qr(torch.randn((s, n, n), generator=gen,
                                           device=dev))
        return q.contiguous()

    def case(s, g_dim, a_dim, eigen=True):
        g = torch.randn((s, g_dim, a_dim), generator=gen, device=dev)
        if eigen:
            entry = {'QA': orth(s, a_dim), 'QG': orth(s, g_dim),
                     'dA': 0.1 + 1.9 * torch.rand((s, a_dim), generator=gen,
                                                  device=dev),
                     'dG': 0.1 + 1.9 * torch.rand((s, g_dim), generator=gen,
                                                  device=dev)}
        else:
            def spd(n):
                m = torch.randn((s, n, n), generator=gen, device=dev)
                return (m @ m.mT / n + 0.5 * torch.eye(n, device=dev)
                        ).contiguous()
            entry = {'A_inv': spd(a_dim), 'G_inv': spd(g_dim)}
        damping = 0.003

        def kern(bf16, both=True):
            return K.bucket_precond(g, entry, damping,
                                    compute_dtype=torch.bfloat16 if bf16
                                    else None)

        def plain(bf16, both=True):
            return K.bucket_precond_plain(g, entry, damping, bf16=bf16)

        def library():
            if eigen:
                qa, qg = entry['QA'], entry['QG']
                t = torch.bmm(torch.bmm(qg.mT, g), qa) / (
                    entry['dG'][:, :, None] * entry['dA'][:, None, :]
                    + damping)
                v = torch.bmm(torch.bmm(qg, t), qa.mT)
            else:
                v = torch.bmm(torch.bmm(entry['G_inv'], g), entry['A_inv'])
            return v, (v * g).sum(dim=(1, 2))

        ins = g_dim * a_dim + a_dim * a_dim + g_dim * g_dim
        ins += (a_dim + g_dim) if eigen else 0
        nbytes = 4 * s * (ins + g_dim * a_dim + 1)
        flops = s * (4 if eigen else 2) * g_dim * a_dim * (a_dim + g_dim)
        return kern, plain, library, nbytes, flops

    return [
        ('(1,16,27)', 1, lambda: case(1, 16, 27)),
        ('(10,16,144)', 1, lambda: case(10, 16, 144)),
        ('(1,32,144)', 1, lambda: case(1, 32, 144)),
        ('(9,32,288)', 1, lambda: case(9, 32, 288)),
        ('(1,64,288)', 1, lambda: case(1, 64, 288)),
        ('(9,64,576)', 1, lambda: case(9, 64, 576)),
        ('(1,10,65)', 1, lambda: case(1, 10, 65)),
        ('baked (3,10,65)', 0, lambda: case(3, 10, 65, eigen=False)),
        ('ragged (2,70,130)', 0, lambda: case(2, 70, 130)),
    ]


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max over outputs of max abs error / max |ref|)."""
    import torch
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    abs_err, rel = 0.0, 0.0
    for g, r in zip(got, ref, strict=True):
        if g.shape != r.shape:
            raise AssertionError(f'shape {tuple(g.shape)} != '
                                 f'{tuple(r.shape)}')
        if not torch.isfinite(g).all():
            raise AssertionError('non-finite kernel output')
        err = float((g - r).abs().max())
        abs_err = max(abs_err, err)
        rel = max(rel, err / max(float(r.abs().max()), 1e-30))
    return abs_err, rel


def check_kernels(quick: bool) -> tuple[dict, list]:
    import torch
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    families = {'factor_ema': factor_ema_cases(gen, dev),
                'patch_cov': patch_cov_cases(gen, dev),
                'bucket_precond': bucket_precond_cases(gen, dev)}
    summary, details = {}, []
    for name, cases in families.items():
        agg = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0,
               't_bytes': 0.0, 't_ops': 0.0, 'max_abs_err': 0.0}
        for label, count, make in cases:
            kern, plain, library, nbytes, flops = make()
            row = {'kernel': name, 'case': label, 'per_step': count}
            for mode, bf16, tol in (('fp32', False, TOL_FP32[name]),
                                    ('bf16', True, TOL_BF16)):
                got = kern(bf16)
                torch.cuda.synchronize()
                ref = plain(bf16)
                abs_err, rel = rel_err(got, ref)
                row[f'{mode}_abs_err'] = abs_err
                row[f'{mode}_rel_err'] = rel
                if not rel <= tol:
                    raise AssertionError(
                        f'{name} {label} {mode}: rel err {rel:.3g} > {tol}')
            msg = (f'  {name:15s} {label:32s} fp32 rel '
                   f'{row["fp32_rel_err"]:.2e}  bf16 rel '
                   f'{row["bf16_rel_err"]:.2e}')
            if not quick and count:
                row['ms'] = time_ms(lambda: kern(False, both=False))
                row['plain_ms'] = time_ms(lambda: plain(False, both=False))
                row['library_ms'] = time_ms(library)
                row['bound_ms'], row['bound_by'] = bound(nbytes, flops)
                msg += (f'  ms {row["ms"]:.4f} plain {row["plain_ms"]:.4f}'
                        f' lib {row["library_ms"]:.4f} bound '
                        f'{row["bound_ms"]:.4f} ({row["bound_by"]})')
                agg['ms'] += count * row['ms']
                agg['plain_ms'] += count * row['plain_ms']
                agg['library_ms'] += count * row['library_ms']
                agg['t_bytes'] += count * nbytes / PEAK_BYTES * 1e3
                agg['t_ops'] += count * flops / PEAK_FP32_FLOPS * 1e3
                agg['max_abs_err'] = max(agg['max_abs_err'],
                                         row['fp32_abs_err'])
            log(msg)
            details.append(row)
            del kern, plain, library
        summary[name] = agg
    return summary, details


def run_main_path() -> tuple[dict, dict]:
    from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    config = {'model': 'resnet32', 'batch_size': 128,
              'synthetic_size': 128, 'val_batch_size': 32,
              'epochs': STEPS, 'no_augment': True, 'seed': 0,
              'kfac_update_freq': 10, 'kfac_cov_update_freq': 1,
              'damping': 0.003, 'kl_clip': 0.001, 'base_lr': 0.1,
              'momentum': 0.9, 'wd': 5e-4, 'time_steps': True,
              'quiet': True}
    kernels.reset_launches()
    res = train_cifar10_resnet.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    losses = res['losses']
    n = res['steps']
    log(f'  losses: {[round(v, 4) for v in losses]}')
    if n != STEPS or len(losses) != STEPS:
        raise AssertionError(f'expected {STEPS} steps, ran {n}')
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('non-finite loss on the main path')
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f'loss did not decrease: first five '
                             f'{first:.4f}, last five {last:.4f}')
    for name, per_step in EXPECTED_PER_STEP.items():
        if launches[name] != per_step * n:
            raise AssertionError(f'{name}: {launches[name]} launches, '
                                 f'expected {per_step} x {n}')
    ms, fired = res['step_ms'], res['fired']
    firing = [t for i, (t, f) in enumerate(zip(ms, fired))
              if f == 'inverse' and i > 0]
    plain = [t for i, (t, f) in enumerate(zip(ms, fired))
             if f == 'factor' and i > 1]
    summary = {'steps': n, 'loss_first5': first, 'loss_last5': last,
               'firing_ms_median': statistics.median(firing),
               'nonfiring_ms_median': statistics.median(plain),
               'launches': launches, 'val': res['val']}
    log(f'  loss first five {first:.4f} -> last five {last:.4f}; '
        f'launches {launches}')
    return summary, res


def _category(name: str) -> str:
    """Coarse owner of a CUDA kernel, from its (mangled) name."""
    n = name.lower()
    if 'gram_' in n:
        return 'K2 patch_cov' if 'patchloader' in n else 'K1 factor_ema'
    if 'bgemm_kernel' in n or 'vg_reduce' in n:
        return 'K3 bucket_precond'
    if 'conv' in n or 'cudnn' in n or 'implicit_gemm' in n or 'wgrad' in n \
            or 'dgrad' in n:
        return 'model convolutions (cuDNN)'
    if 'gemm' in n or 'cutlass' in n or 'sm90_' in n or 'gemv' in n:
        return 'matmul (cuBLAS: warm polish, linear head)'
    if 'batch_norm' in n or 'bn_' in n:
        return 'batch norm'
    if 'reduce' in n:
        return 'reductions'
    return 'elementwise / copies / other'


def profile_main_path(steps: int = 5) -> dict:
    """torch.profiler over ``steps`` steady non-firing steps and one firing
    step of the main path: device time by kernel category and the device's
    busy share (kernel time / wall time of the profiled window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
    from distributed_kfac_pytorch_tpu_torch.training import datasets, \
        engine, optimizers
    dev = torch.device('cuda')
    (x, y), _ = datasets.get_cifar(synthetic_size=128)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = cifar_resnet.get_model('resnet32').to(dev)
    cfg = optimizers.OptimConfig(kfac_inv_update_freq=10,
                                 kfac_cov_update_freq=1)
    optimizer, _, kfac, sched = optimizers.get_optimizer(model, cfg, dev)
    state = engine.TrainState(model=model, optimizer=optimizer, kfac=kfac,
                              kfac_state=kfac.init_state())
    hyper = {'lr': 0.1, **sched.params()}
    xb = torch.as_tensor(x, device=dev)
    yb = torch.as_tensor(y, device=dev)

    def step():
        flags = engine.cadence_flags(state.step, 1, 10)
        engine.train_step(state, xb, yb, hyper, flags)
        state.step += 1

    while state.step < 11:            # warm-up, incl. the firings at 0, 10
        step()
    torch.cuda.synchronize()
    out = {}
    for label, n in (('non_firing', steps), ('firing', 1)):
        if label == 'firing':
            while state.step % 10:
                step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        cats: dict[str, float] = {}
        kernels_ms = 0.0
        for ev in prof.key_averages():
            dt = getattr(ev, 'self_device_time_total', None)
            if dt is None:
                dt = ev.self_cuda_time_total
            if not dt or ev.device_type.name != 'CUDA':
                continue
            ms = dt / 1e3 / n
            cats[_category(ev.key)] = cats.get(_category(ev.key), 0.0) + ms
            kernels_ms += ms
        out[label] = {'wall_ms_per_step': wall_ms,
                      'device_kernel_ms_per_step': kernels_ms,
                      'device_busy_share': kernels_ms / wall_ms,
                      'by_category_ms': dict(sorted(
                          cats.items(), key=lambda kv: -kv[1]))}
        log(f'  {label}: wall {wall_ms:.2f} ms/step, device kernels '
            f'{kernels_ms:.2f} ms/step, busy {kernels_ms / wall_ms:.1%}')
        for cat, ms in out[label]['by_category_ms'].items():
            log(f'    {cat:45s} {ms:8.3f} ms')
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--quick', action='store_true',
                    help='build verbosely and check the kernels only')
    ap.add_argument('--profile', action='store_true',
                    help='also profile steady main-path steps')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_kfac_pytorch_tpu_torch import set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.ops import kernels

    set_fp32_precision()
    card = card_line()
    log('== environment')
    log(f'  {card}')
    log(f'  torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'python {sys.version.split()[0]}, device '
        f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}')
    log(f'  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, '
        f'cudnn {torch.backends.cudnn.allow_tf32}')

    log('== build')
    t0 = time.perf_counter()
    paths = kernels.build(verbose=args.quick)
    log(f'  built {sorted(p.name for p in paths.values())} in '
        f'{time.perf_counter() - t0:.1f} s')

    log('== kernels vs plain versions')
    summary, details = check_kernels(args.quick)
    report = {'card': card, 'kernel_cases': details}
    if not args.quick:
        log('== main path: ResNet-32, batch 128, '
            f'{STEPS} K-FAC steps on one batch')
        main_summary, res = run_main_path()
        log(f'  steady ms/step: non-firing '
            f'{main_summary["nonfiring_ms_median"]:.2f}, firing '
            f'{main_summary["firing_ms_median"]:.2f} ({card})')
        report['main_path'] = main_summary
        report['step_ms'] = res['step_ms']
        report['fired'] = res['fired']
        line = []
        for name, agg in summary.items():
            t_bytes, t_ops = agg['t_bytes'], agg['t_ops']
            line.append({
                'name': name, 'route': 'cuda',
                'source': kernels.KERNEL_INFO[name]['source'],
                'replaces': kernels.KERNEL_INFO[name]['replaces'],
                'launches': main_summary['launches'][name],
                'max_abs_err': agg['max_abs_err'],
                'ms': agg['ms'], 'plain_ms': agg['plain_ms'],
                'bound_ms': max(t_bytes, t_ops),
                'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
                'library_ms': agg['library_ms']})
        report['kernels'] = line
        if args.profile:
            log('== profile: device time by kernel category')
            report['profile'] = profile_main_path()
    out_dir = ROOT / 'chiprun_out'
    out_dir.mkdir(exist_ok=True)
    (out_dir / 'chip_smoke.json').write_text(json.dumps(report, indent=1))
    if args.quick:
        log('quick check passed')
        return 0
    log(card)
    log(json.dumps({'kernels': report['kernels']}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        code = main()
    except Exception:  # report and fail: no phase failure is swallowed
        traceback.print_exc()
        code = 1
    sys.exit(code)
