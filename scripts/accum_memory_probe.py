#!/usr/bin/env python3
"""Peak device memory of ResNet-50 training steps on one H100, by batch,
``--grad-accum`` and ``--remat``.

    python3 scripts/accum_memory_probe.py [BATCH:ACCUM[:remat][:sgd] ...]

Each case (default: 64:1 256:4 256:1 256:1:remat 512:8 512:2:remat, then
256:1:sgd and 256:1:remat:sgd, the SGD baseline without K-FAC's
captures) is a subprocess that runs the ImageNet CLI in process at 224
px, one fixed synthetic batch, 2 steps (K-FAC: factors every step, the
inverse firing at step 0, ``auto``), and
prints the peak of allocated device memory, the peak reserved by the
caching allocator, the step ms, or that the case ran out of device memory
(the subprocess then exits 3; the probe goes on to the next case). Which
cases fit decides what ``chip_smoke.py`` phase 29 runs. Prints a line per
case and writes ``chiprun_out/accum_memory_probe.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_CASES = ('64:1', '256:4', '256:1', '256:1:remat', '512:8',
                 '512:2:remat', '256:1:sgd', '256:1:remat:sgd')


def run_case(spec: str) -> int:
    """One case in this process: prints a ``RESULT`` JSON line."""
    import torch
    sys.path.insert(0, str(ROOT))
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    parts = spec.split(':')
    batch, accum = int(parts[0]), int(parts[1])
    remat, sgd = 'remat' in parts[2:], 'sgd' in parts[2:]
    config = {'model': 'resnet50', 'image_size': 224, 'batch_size': batch,
              'synthetic_size': batch, 'val_batch_size': 64,
              'no_augment': True, 'seed': 0, 'epochs': 2,
              'kfac_update_freq': 0 if sgd else 10,
              'kfac_cov_update_freq': 1,
              'grad_accum': accum, 'remat': remat, 'time_steps': True,
              'quiet': True}
    torch.cuda.reset_peak_memory_stats()
    try:
        res = train_imagenet_resnet.train(config, device='cuda')
    except torch.cuda.OutOfMemoryError as e:
        print('RESULT ' + json.dumps({'case': spec, 'fits': False,
                                      'error': str(e).splitlines()[0]}),
              flush=True)
        return 3
    print('RESULT ' + json.dumps({
        'case': spec, 'fits': True,
        'peak_allocated_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
        'peak_reserved_gib': torch.cuda.max_memory_reserved() / 2 ** 30,
        'step_ms': res['step_ms'], 'losses': res['losses']}), flush=True)
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ['--case']:
        return run_case(argv[1])
    import torch
    if not torch.cuda.is_available():
        print('accum_memory_probe: no CUDA device available',
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    card = cs.card_line()
    print(card, flush=True)
    kernels.build()
    out = {'card': card, 'cases': []}
    for spec in argv or DEFAULT_CASES:
        proc = subprocess.run([sys.executable, __file__, '--case', spec],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith('RESULT ')), None)
        if line is None:
            print(proc.stdout[-2000:] + proc.stderr[-2000:], flush=True)
            raise SystemExit(f'case {spec}: exit {proc.returncode}, no '
                             'result')
        rec = json.loads(line[len('RESULT '):])
        out['cases'].append(rec)
        if rec['fits']:
            print(f'{spec}: peak allocated {rec["peak_allocated_gib"]:.2f} '
                  f'GiB, reserved {rec["peak_reserved_gib"]:.2f} GiB; step '
                  f'ms {[round(t, 1) for t in rec["step_ms"]]}', flush=True)
        else:
            print(f'{spec}: out of device memory ({rec["error"]})',
                  flush=True)
    dest = ROOT / 'chiprun_out'
    dest.mkdir(exist_ok=True)
    (dest / 'accum_memory_probe.json').write_text(json.dumps(out, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
