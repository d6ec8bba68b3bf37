#!/usr/bin/env python3
"""Tile sweep of the K2 kernel (conv-A patch covariance) on one H100.

    python3 scripts/k2_tiles.py     # needs one CUDA device and nvcc

Times K2 (``ops.kernels.patch_cov``'s launch) at every conv A shape of the
ResNet-50 path (224 px, batch 64) and of the ResNet-32 path (batch 128),
on the random inputs of ``chip_smoke.py`` phase 3, fp32, under each tile
edge ``patch_cov_plan`` can choose (32, 64, 128), each with the split the
plan's model gives it. Beside each time: the staging path, the tile pairs,
chunks and waves of resident blocks, the k-tiles a block walks, the
microseconds per k-tile that gives (time / (waves x (k-tiles per chunk +
2)): what ``_K1_US_PER_KTILE`` and ``_K2_US_PER_KTILE`` model) beside the
model's total, and which tile the plan picks. Prints a line per case and
writes ``chiprun_out/k2_tiles.json``.
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
        print('k2_tiles: no CUDA device available', file=sys.stderr)
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
    shapes = [('r50', (cs.R50_BATCH, c, h, w), k, s, count)
              for (c, h, w), k, s, count in cs.resnet50_shapes()['conv_a']]
    shapes += [('r32', (128, c, hw, hw), (3, 3), s, count)
               for c, hw, s, count in ((3, 32, (1, 1), 1),
                                       (16, 32, (1, 1), 10),
                                       (16, 32, (2, 2), 1),
                                       (32, 16, (1, 1), 9),
                                       (32, 16, (2, 2), 1),
                                       (64, 8, (1, 1), 9))]
    rows, per_step = [], {}
    for model, shape, k, s, count in shapes:
        x = torch.randn(shape, generator=gen, device=dev)
        pads = K._canonical_pad((k[0] // 2, k[1] // 2), k, shape[2:], s)
        chosen = K.patch_cov_plan(shape, x.stride(), k, s, pads, False, sms,
                                  aligned=x.data_ptr() % 16 == 0)
        label = (f'{model} D={chosen.d_in} {shape} k{k[0]} s{s[0]} '
                 f'x{count}')
        row = {'case': label, 'model': model, 'count': count,
               'path': chosen.path, 'chosen': chosen.tile}
        for tile in K._K1_BLOCKS_PER_SM:
            plan = K._k2_plan(shape, x.stride(), k, s, pads, False, tile,
                              sms, x.data_ptr() % 16 == 0)
            ms = cs.time_ms(lambda: K._patch_cov_launch(plan, x, k, s,
                                                        False, False),
                            reps=3 if chosen.d_in >= 1024 else 10)
            slots = sms * K._K1_BLOCKS_PER_SM[tile]
            waves = -(-plan.npairs * plan.chunks // slots)
            kpc = plan.rows_per_chunk // 32
            row[tile] = {'ms': ms, 'pairs': plan.npairs,
                         'chunks': plan.chunks, 'waves': waves,
                         'ktiles_per_chunk': kpc,
                         'us_per_ktile': 1e3 * ms / (waves * (kpc + 2)),
                         'model_ms': plan.us / 1e3}
            key = (model, tile)
            per_step[key] = per_step.get(key, 0.0) + count * ms
        per_step[(model, 'chosen')] = per_step.get((model, 'chosen'), 0.0) \
            + count * row[chosen.tile]['ms']
        rows.append(row)
        times = '  '.join(
            f'{t}: {row[t]["ms"]:.4f} ms ({row[t]["pairs"]}p x '
            f'{row[t]["chunks"]}c, {row[t]["waves"]} waves, '
            f'{row[t]["us_per_ktile"]:.2f} us/kt, model '
            f'{row[t]["model_ms"]:.4f})' for t in K._K1_BLOCKS_PER_SM)
        print(f'{label:44s} {chosen.path:8s} {times}  plan {chosen.tile}',
              flush=True)
    for (model, tile), ms in sorted(per_step.items(), key=str):
        print(f'  {model} per step at tile {tile}: {ms:.3f} ms ({card})')
    out = ROOT / 'chiprun_out'
    out.mkdir(exist_ok=True)
    (out / 'k2_tiles.json').write_text(json.dumps(
        {'card': card, 'rows': rows,
         'per_step': {f'{m} {t}': v for (m, t), v in per_step.items()}},
        indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
