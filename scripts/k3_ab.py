#!/usr/bin/env python3
"""K3 (bucketed preconditioning) alone, in the checkout given, on one H100.

    python3 scripts/k3_ab.py [ROOT]    # ROOT: a checkout (default: this one)

Imports ``chip_smoke`` and the port from ROOT (so an unpacked parent tree
can be timed beside this one in one call, in turns), builds its kernels
and times K3 at the main-path buckets of ``chip_smoke.py`` phase 3 (the
ResNet-32 buckets, eigen; the ResNet-50 buckets, baked; the LSTM bucket,
eigen), fp32: per bucket the CUDA-event ms per call
(``chip_smoke.time_ms``) and the host's enqueue time per call (50 calls
without a sync), summed per step with the launches per step. Prints one
line per model and writes ``chiprun_out/k3_ab_<ROOT>_<time>.json``.
"""

import json
import sys
import time
from pathlib import Path


def main() -> int:
    root = sys.argv[1] if len(sys.argv) > 1 else str(
        Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print('k3_ab: no CUDA device available', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from distributed_kfac_pytorch_tpu_torch import set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K

    set_fp32_precision()
    K.build()
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {'card': cs.card_line()}
    models = (('r32', cs.bucket_precond_cases(gen, dev)),
              ('r50', cs.bucket_precond_cases(gen, dev,
                                              cs.resnet50_shapes())),
              ('lstm', cs.lstm_bucket_precond_cases(gen, dev)))
    for model, cases in models:
        tot, host = 0.0, 0.0
        for label, count, make in cases:
            if not count:
                continue
            kern = make()[0]

            def call():
                kern(False, both=False)
            ms = cs.time_ms(call, 20 if model == 'r32' else 5)
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                call()
            h = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
            tot += count * ms
            host += count * h
            out[f'{model} {label}'] = (ms, h)
        out[model] = (tot, host)
        print(root, model, 'ms/step', round(tot, 4), 'host ms/step',
              round(host, 4), flush=True)
    dest = Path(__file__).resolve().parent.parent / 'chiprun_out'
    dest.mkdir(exist_ok=True)
    tag = root.strip('/').replace('/', '_') or 'root'
    (dest / f'k3_ab_{tag}_{int(time.time())}.json').write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
