#!/usr/bin/env python3
"""``chip_smoke.py`` phase 3 (K1-K3) of the checkout given, on one H100.

    python3 scripts/k2_ab.py [ROOT]    # ROOT: a checkout (default: this one)

Imports ``chip_smoke`` and the port from ROOT, so an unpacked parent tree
can be measured beside this one in one call, in turns (parent, new, new,
parent). Builds ROOT's kernels and runs its ``check_kernels`` at the
ResNet-32 and the ResNet-50 shapes: every case held against its plain
version and timed (CUDA events, ``chip_smoke.time_ms``). Prints each
case, then per model and kernel the ms per step summed over the launches
beside the plain version's and the library's, and writes
``chiprun_out/k2_ab_<ROOT>_<time>.json``.
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
        print('k2_ab: no CUDA device available', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from distributed_kfac_pytorch_tpu_torch import set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K

    set_fp32_precision()
    K.build()
    card = cs.card_line()
    out = {'root': root, 'card': card}
    for model, shapes in (('r32', None), ('r50', cs.resnet50_shapes())):
        summary, details = cs.check_kernels(False, shapes)
        out[model] = {'summary': summary, 'cases': details}
        for name, agg in summary.items():
            print(f'{root} {model} {name}: {agg["ms"]:.3f} ms per step, '
                  f'plain {agg["plain_ms"]:.3f}, library '
                  f'{agg["library_ms"]:.3f} ({card})', flush=True)
    dest = Path(__file__).resolve().parent.parent / 'chiprun_out'
    dest.mkdir(exist_ok=True)
    tag = Path(root).resolve().name
    (dest / f'k2_ab_{tag}_{int(time.time())}.json').write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
