#!/usr/bin/env python3
"""Where a ResNet-50 step of ``DistributedKFAC`` at world size 1 (NCCL)
spends the time the single-device ``KFAC`` step does not. On one H100:

    python3 scripts/nccl_world1_profile.py

ResNet-50 at 224 px, batch 64, ``newton``, factors every step: five
timed non-firing steps of the single-device ``KFAC`` and of a
``DistributedKFAC`` in a one-rank NCCL group, each twice in turns; for
each, the factor update and the preconditioning timed alone; for the
distributed path also the flat copy and the ``all_reduce`` of the factor
contributions, the gradient and BatchNorm-buffer averages, and a
``torch.profiler`` table of one step by device and by host time.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('nccl_world1_profile: no CUDA device available',
              file=sys.stderr)
        return 2
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C
    from distributed_kfac_pytorch_tpu_torch import launch, \
        set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.models import imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine

    set_fp32_precision()
    print(C.card_line(), flush=True)
    kernels.build()
    store = C._fresh_store('profile.store')
    launch.initialize_distributed(init_method=f'file://{store}', rank=0,
                                  world_size=1, device='cuda')
    x = torch.randn(64, 3, 224, 224, device='cuda')
    y = torch.randint(0, 1000, (64,), device='cuda')
    loss_fn = lambda out: F.cross_entropy(out, y)  # noqa: E731

    def make(distributed: bool):
        torch.manual_seed(0)
        model = imagenet_resnet.get_model('resnet50').cuda()
        opt = torch.optim.SGD(model.parameters(), lr=0.0125, momentum=0.9,
                              weight_decay=5e-5)
        kfac = KFAC(model, inverse_method='newton', factor_update_freq=1,
                    inv_update_freq=10, damping=0.001, kl_clip=0.001,
                    lr=0.0125, device='cuda')
        if distributed:
            kfac = DistributedKFAC(kfac)
        return engine.TrainState(model=model, optimizer=opt, kfac=kfac,
                                 kfac_state=kfac.init_state(),
                                 distributed=distributed)

    def step(st, inv=False):
        return engine.train_step(st, x, y, {'lr': 0.0125, 'damping': 0.001},
                                 {'factor_update': True, 'inv_update': inv})

    def timed(label, fn, reps=3):
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            print(label, 'ms', (time.perf_counter() - t0) * 1e3, flush=True)
        return out

    for distributed in (False, True, False, True):
        st = make(distributed)
        step(st, True)
        step(st)
        step(st)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(st)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        name = 'distributed' if distributed else 'single'
        print(name, 'non-firing ms', sorted(ms)[2],
              [round(t, 2) for t in ms], flush=True)
        _, _, g, c = st.kfac.capture.loss_and_grads(loss_fn, x)
        if distributed:
            dk = st.kfac
            contribs = timed('contributions', lambda: dk.local_factor_contribs(
                c), 1)
            timed('update_factors', lambda: dk.update_factors(
                st.kfac_state, contribs))
            parts = [contribs[n][s] for n in dk.specs for s in 'AG']
            flat = timed('flat copy', lambda: torch.cat(
                [t.reshape(-1) for t in parts]))
            timed(f'all_reduce of {flat.numel() * 4} bytes',
                  lambda: dist.all_reduce(flat))
            timed('precondition', lambda: dk.precondition(
                st.kfac_state['inv_stacks'], g, 0.001, 0.0125))
            timed('world_mean of the gradients',
                  lambda: engine.world_mean(list(g.values())), 1)
            timed('average_buffers', lambda: engine.average_buffers(
                st.model), 1)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(st)
                torch.cuda.synchronize()
            print(prof.key_averages().table(sort_by='self_cuda_time_total',
                                            row_limit=14))
            print(prof.key_averages().table(sort_by='self_cpu_time_total',
                                            row_limit=12))
        else:
            timed('single update_factors', lambda: st.kfac.update_factors(
                st.kfac_state, c))
            timed('single precondition', lambda: st.kfac.precondition(
                st.kfac_state, g, 0.001, 0.0125))
        del st
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
