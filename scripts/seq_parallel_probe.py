#!/usr/bin/env python3
"""What the long-context attention of the port costs on one H100, and
which transport its ring can use there:

    python3 scripts/seq_parallel_probe.py

1. Transport: two gloo ranks on ``cuda:0`` exchange a CUDA tensor with
   ``batch_isend_irecv`` (gloo has no send/recv on CUDA tensors: this is
   expected to fail, which is why the ring's shift stages gloo exchanges
   through host memory), and one NCCL rank exchanges one with itself.
2. Memory of ``chip_smoke.py``'s phase 15 model (Transformer-XL width,
   18 blocks, batch 4 x 1024) with plain attention and with
   ``--attn-block-size 256``, 3 K-FAC steps (a firing at step 0): the
   allocated memory before the step, after the forward pass (the
   residuals), the peak of forward + backward and the peak of the K-FAC
   step alone.
3. One block's attention, (4, 1024, 16, 64), forward + backward, plain /
   folded in blocks of 256 / plain, 6 runs each (host clock after
   ``synchronize``).
4. ``chip_smoke.profile_main_path('transformer_xl')`` plain, at block
   256 and plain again: device time per step by kernel category.

Prints each result as it comes and writes them all to
``chiprun_out/seq_parallel_probe.json``.
"""

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

EXCHANGE = r'''
import json, sys, torch, torch.distributed as dist
backend, rank, world, store = sys.argv[1], int(sys.argv[2]), \
    int(sys.argv[3]), sys.argv[4]
torch.cuda.set_device(0)
dist.init_process_group(backend, init_method='file://' + store, rank=rank,
                        world_size=world)
sent = torch.full((4,), float(rank + 1), device='cuda')
got = torch.empty_like(sent)
try:
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, sent, (rank + 1) % world),
            dist.P2POp(dist.irecv, got, (rank - 1) % world)]):
        req.wait()
    torch.cuda.synchronize()
    res = {'ok': True, 'got': got.tolist()}
except RuntimeError as e:
    res = {'ok': False, 'error': str(e)[:300]}
print('RESULT', json.dumps({'backend': backend, 'rank': rank, **res}))
dist.destroy_process_group()
'''


def transport() -> list:
    out = []
    for backend, world in (('gloo', 2), ('nccl', 1)):
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen(
                [sys.executable, '-c', EXCHANGE, backend, str(r), str(world),
                 f'{tmp}/store'], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(world)]
            for p in procs:
                try:
                    log = p.communicate(timeout=120)[0]
                except subprocess.TimeoutExpired:
                    p.kill()
                    log = p.communicate()[0] + '\nTIMEOUT'
                lines = [json.loads(ln.split(' ', 1)[1])
                         for ln in log.splitlines()
                         if ln.startswith('RESULT')]
                out += lines or [{'backend': backend, 'log': log[-500:]}]
                print('transport', out[-1], flush=True)
    return out


def memory(C, block) -> list:
    import torch
    from distributed_kfac_pytorch_tpu_torch import train_language_model
    from distributed_kfac_pytorch_tpu_torch.training import engine, \
        optimizers
    gib = 2 ** 30
    dev = torch.device('cuda')
    x, y = (torch.as_tensor(t, device=dev).long()
            for t in C._xl_first_window())
    args = engine.parse_args(train_language_model.build_parser(),
                             C._xl_config(attn_block_size=block))
    model = train_language_model.build_model(args, C.XL_VOCAB, dev)
    cfg = optimizers.OptimConfig(base_lr=1.0, weight_decay=0.0,
                                 lr_decay=(20, 30), kfac_inv_update_freq=10,
                                 kfac_cov_update_freq=1, skip_layers=[])
    _, _, kfac, _ = optimizers.get_optimizer(model, cfg, dev)
    state = kfac.init_state()
    rec = []
    for step in range(3):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model.zero_grad(set_to_none=True)
        with kfac.capture.recording(True):
            loss = engine.lm_loss(model(x), y)
            torch.cuda.synchronize()
            after_fwd = torch.cuda.memory_allocated()
            loss.backward()
        del loss
        torch.cuda.synchronize()
        peak_fwd_bwd = torch.cuda.max_memory_allocated()
        grads = {n: p.grad for n, p in model.named_parameters()}
        captures = kfac.capture.collect()
        torch.cuda.reset_peak_memory_stats()
        _, state = kfac.step(state, grads, captures, lr=1.0,
                             factor_update=True, inv_update=step == 0)
        torch.cuda.synchronize()
        r = {'block': block, 'step': step, 'base_gib': base / gib,
             'after_forward_gib': after_fwd / gib,
             'peak_forward_backward_gib': peak_fwd_bwd / gib,
             'peak_kfac_step_gib': torch.cuda.max_memory_allocated() / gib}
        del grads, captures
        rec.append(r)
        print('memory', {k: round(v, 3) if isinstance(v, float) else v
                         for k, v in r.items()}, flush=True)
    kfac.capture.close()
    del model, kfac, state
    C._release()
    return rec


def one_block(C) -> dict:
    import torch
    from distributed_kfac_pytorch_tpu_torch.parallel import sequence
    gen = torch.Generator(device='cuda').manual_seed(0)
    q, k, v, w = (torch.randn((C.XL_BATCH, C.XL_BPTT, C.XL_HEADS,
                               C.XL_D // C.XL_HEADS), generator=gen,
                              device='cuda') for _ in range(4))
    out = {}
    for name, fn in (
            ('plain', sequence.local_causal_attention),
            ('block256', lambda q, k, v: sequence.chunked_causal_attention(
                q, k, v, block_size=256)),
            ('plain_again', sequence.local_causal_attention)):
        runs = [C._attention_run(fn, q, k, v, w) for _ in range(6)]
        out[name] = {'ms': [r['ms'] for r in runs],
                     'peak_gib': runs[-1]['peak_gib']}
        print('one block', name, {k: v for k, v in out[name].items()},
              flush=True)
    return out


def main() -> int:
    import torch
    import chip_smoke as C
    from distributed_kfac_pytorch_tpu_torch import set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    if not torch.cuda.is_available():
        print('seq_parallel_probe: no CUDA device', file=sys.stderr)
        return 2
    set_fp32_precision()
    kernels.build()
    card = C.card_line()
    print(card, flush=True)
    out = {'card': card, 'transport': transport(),
           'memory': memory(C, None) + memory(C, 256),
           'one_block': one_block(C), 'profile': {}}
    for label, block in (('plain', None), ('block256', 256),
                         ('plain_again', None)):
        prof = C.profile_main_path('transformer_xl', attn_block_size=block)
        out['profile'][label] = prof
        C._release()
    path = ROOT / 'chiprun_out' / 'seq_parallel_probe.json'
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(card)
    return 0


if __name__ == '__main__':
    sys.exit(main())
