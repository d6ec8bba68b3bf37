#!/usr/bin/env python3
"""Tile sweep of the K3 kernel (bucketed preconditioning) on one H100.

    python3 scripts/k3_tiles.py     # needs one CUDA device and nvcc

Times K3 (``ops.kernels.bucket_precond``'s launch) at each bucket of the
ResNet-50 path (baked), the LSTM LM's (16, 650, 651) bucket (eigen and
baked) and three ResNet-32 buckets (eigen) under each tile height
``bucket_precond_plan`` can choose (64 and 128 rows of G by 128 columns
of A), on the random inputs of ``chip_smoke.py`` phase 3, fp32. Beside
each time: the plan's waves per product, the k-tiles a block walks over
the chain, the microseconds per k-tile that gives (time / k-tiles: the
time per k-tile of the busiest SM's blocks, which ``_K3_US_PER_KTILE``
models) beside the model's, and which tile the plan picks. Prints a line
per case and writes ``chiprun_out/k3_tiles.json``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('k3_tiles: no CUDA device available', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from distributed_kfac_pytorch_tpu_torch import set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K

    set_fp32_precision()
    card = cs.card_line()
    print(card, flush=True)
    K.build()
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = K._sm_count(0)
    buckets = [(s, g, a, False)
               for (g, a), s in cs.resnet50_shapes()['buckets']]
    buckets += [(16, 650, 651, True), (16, 650, 651, False),
                (9, 64, 576, True), (9, 32, 288, True), (10, 16, 144, True)]
    rows = []
    for s, g_dim, a_dim, eigen in buckets:
        cases = {label: make for label, _, make in cs.bucket_precond_cases(
            gen, dev, {'buckets': [((g_dim, a_dim), s)]})}
        label = f'{"eigen" if eigen else "baked"} ({s},{g_dim},{a_dim})'
        kern = cases[label]()[0]
        chosen = kern.plan
        gstack, entry, damping = kern.inputs
        ktiles = sum(-(-k // 32) for k in (
            (a_dim, g_dim, a_dim, g_dim) if eigen else (a_dim, g_dim)))
        row = {'case': label, 'chosen': chosen.tile_m,
               'path': chosen.path, 'ktiles': ktiles}
        for tile_m in K._K3_BLOCKS_PER_SM:
            plan = K._k3_plan(s, g_dim, a_dim, eigen, chosen.path, tile_m,
                              sms)
            ms = cs.time_ms(lambda: K._bucket_precond_launch(
                plan, gstack, entry, damping, False), reps=5)
            row[tile_m] = {'ms': ms, 'waves': plan.waves,
                           'us_per_ktile': 1e3 * ms / ktiles,
                           'model_us_per_ktile': plan.us_per_ktile}
        rows.append(row)
        times = '  '.join(f'{t}: {row[t]["ms"]:.4f} ms ({row[t]["waves"]} '
                          f'waves, {row[t]["us_per_ktile"]:.2f} us/k-tile, '
                          f'model {row[t]["model_us_per_ktile"]:.2f})'
                          for t in K._K3_BLOCKS_PER_SM)
        print(f'{label:24s} {chosen.path:5s} k-tiles {ktiles:4d}  {times}'
              f'  plan {chosen.tile_m}', flush=True)
    out = ROOT / 'chiprun_out'
    out.mkdir(exist_ok=True)
    (out / 'k3_tiles.json').write_text(json.dumps(
        {'card': card, 'rows': rows}, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
