#!/usr/bin/env python3
"""Is ``chip_smoke.py`` phase 6 reproducible, and does phase 13 (the same
ResNet-50 ``newton`` run as ``DistributedKFAC`` in a one-rank NCCL group)
follow it? On one H100:

    python3 scripts/nccl_world1_repro.py

Six 12-step runs of phase 6's configuration, in turns: single device
twice, then with ``torch.backends.cudnn.deterministic`` single device
twice and in a one-rank NCCL group, then the NCCL group without it.
Prints each run's losses and step medians, and the largest relative
loss difference between pairs of runs.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('nccl_world1_repro: no CUDA device available', file=sys.stderr)
        return 2
    import torch.distributed as dist

    import chip_smoke as C
    from distributed_kfac_pytorch_tpu_torch import launch, \
        set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet as T
    from distributed_kfac_pytorch_tpu_torch.ops import kernels

    set_fp32_precision()
    print(C.card_line(), flush=True)
    kernels.build()
    cfg = C._r50_config(epochs=C.R50_STEPS, inverse_method='newton')

    def run(det: bool, nccl: bool) -> list:
        torch.backends.cudnn.deterministic = det
        if nccl:
            store = C._fresh_store('repro.store')
            launch.initialize_distributed(init_method=f'file://{store}',
                                          rank=0, world_size=1,
                                          device='cuda')
        try:
            res = T.train({**cfg, 'comm_method': 'comm-opt'} if nccl
                          else cfg, device='cuda')
        finally:
            if nccl:
                dist.destroy_process_group()
        firing, plain = C._step_ms(res)
        print('det' if det else 'nondet', 'nccl' if nccl else 'single',
              [round(v, 6) for v in res['losses']], 'non-firing',
              round(sorted(plain)[len(plain) // 2], 2), 'firing',
              [round(t, 1) for t in firing], flush=True)
        return res['losses']

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    runs = {key: run(det, nccl) for key, det, nccl in (
        ('A', False, False), ('B', False, False), ('C', True, False),
        ('D', True, False), ('E', True, True), ('F', False, True))}
    print('single vs single:', rel(runs['A'], runs['B']))
    print('deterministic single vs single:', rel(runs['C'], runs['D']))
    print('deterministic single vs NCCL:', rel(runs['C'], runs['E']))
    print('single vs NCCL:', rel(runs['A'], runs['F']))
    print('deterministic single vs NCCL per step:',
          [abs(x - y) / abs(y) for x, y in zip(runs['C'], runs['E'])])
    return 0


if __name__ == '__main__':
    sys.exit(main())
