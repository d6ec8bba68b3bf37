#!/usr/bin/env python3
"""How far the results of ``chip_smoke.py``'s phase 20 move with the
order in which the ranks' sums are reduced: the factors, the gradients
and the preconditioned gradients, in fp32 and in fp64. On one H100:

    python3 scripts/lm_dist_sensitivity.py

Phase 20's COMM_OPT ``expand`` case in one process: the XL-width tied
Transformer at 2 blocks on the fixed batch of 4 sequences, 3 K-FAC steps,
inverses at steps 0 and 2. Each step builds the factors twice from the
same parameters: as the single-device ``KFAC`` does, over the full batch
(K1 over 4096 rows), and as 4 ranks do, the mean of 4 one-sequence
contributions from each sequence's own mean loss (``G`` times 1/16),
taken by ``DistributedKFAC.local_factor_contribs`` in a one-rank gloo
group; the gradients likewise, the full batch's and the mean of the 4
sequences'. Every step it prints, for the parameters whose two gradients
differ most (relative to the largest entry of the full batch's), both
gradients' distance from the full batch's gradient taken by an fp64 copy
of the model. At each firing, for every dense layer, it prints the
factors' difference, and the damped Cholesky preconditioning (``G_inv @
grad @ A_inv``) of each factor set and gradient, in fp32 and in fp64:
the two fp32 results' difference, the two fp64 results' difference and
the condition number of ``A + damping``; and, per weight and bias, both
fp32 results' distance from the fp64 preconditioning of the fp64
gradient. At the last firing, ISOLATE's preconditioned gradient is
recomputed with one input of the single-device step changed at a time. Where the fp64 difference
matches the fp32 one, the spread comes from the inputs, not from the
arithmetic of either path.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LAYERS, STEPS, INV_FREQ, DAMPING, SHARDS = 2, 3, 2, 0.003, 4
# The layer whose last firing is taken apart input by input.
ISOLATE = 'block1.mlp_out'


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('lm_dist_sensitivity: no CUDA device available',
              file=sys.stderr)
        return 2
    import torch.distributed as dist

    import chip_smoke as C
    from distributed_kfac_pytorch_tpu_torch import layers as L
    from distributed_kfac_pytorch_tpu_torch import launch, \
        set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine

    set_fp32_precision()
    kernels.build()
    print(C.card_line(), flush=True)
    store = C._fresh_store('sensitivity.store')
    launch.initialize_distributed(init_method=f'file://{store}', rank=0,
                                  world_size=1, backend='gloo',
                                  device='cuda')
    dev = torch.device('cuda')
    x, y = (torch.as_tensor(t, device=dev).long()
            for t in C._xl_first_window())
    model = C._xl_model(LAYERS, dev)
    kfac = KFAC(model, damping=DAMPING, factor_update_freq=1,
                inv_update_freq=INV_FREQ, kl_clip=0.001, lr=1.0,
                device=dev)
    dk = DistributedKFAC(kfac, comm_method='comm-opt')
    state = kfac.init_state()
    dist_factors = dk.init_state()['factors']
    loss = lambda y_: (lambda o: engine.lm_loss(o, y_))  # noqa: E731

    def precondition(a, g, grad, dtype):
        def inv(m):
            m = m.to(dtype) + DAMPING * torch.eye(m.shape[-1], dtype=dtype,
                                                  device=dev)
            return torch.cholesky_inverse(torch.linalg.cholesky(m))
        return inv(g) @ grad.to(dtype) @ inv(a)

    def isolate(name, spec, state, ref, mine, grads, mean_grads, exact,
                like):
        """The last firing's preconditioned gradient of one layer, per
        weight and bias, against its fp64 recomputation (the full batch's
        factors, the fp64 gradient), with one input of the single-device
        step changed at a time: the step itself (K3 on its stacked
        inverses), the A inverse taken alone (a batch of one), the mean of
        the sequences' gradients, the 4-sequence factors, and torch's fp32
        matmuls in place of K3."""
        from distributed_kfac_pytorch_tpu_torch.ops import linalg
        inv = state['inverses'][name]
        x64 = L.matrix_to_grads(spec, precondition(
            ref['A'], ref['G'], L.grads_to_matrix(spec, kfac._layer_params(
                name, exact)), torch.float64), like)

        def k3(a_inv, g_inv, gs):
            g = L.grads_to_matrix(spec, kfac._layer_params(name, gs))
            v, _ = kernels.bucket_precond(g[None].float(), {
                'A_inv': a_inv[None], 'G_inv': g_inv[None]}, DAMPING)
            return v[0]

        alone = linalg.get_inverse(ref['A'][None], DAMPING)[0]
        variants = {
            'single-device step': k3(inv['A_inv'], inv['G_inv'], grads),
            'A inverse alone': k3(alone, inv['G_inv'], grads),
            'mean gradient': k3(inv['A_inv'], inv['G_inv'], mean_grads),
            '4-sequence factors': k3(
                linalg.get_inverse(mine['A'][None], DAMPING)[0],
                linalg.get_inverse(mine['G'][None], DAMPING)[0], grads),
            'torch matmuls': linalg.precondition_inv(
                L.grads_to_matrix(spec, kfac._layer_params(name, grads)),
                inv['A_inv'], inv['G_inv'])}
        for label, v in variants.items():
            parts = L.matrix_to_grads(spec, v, like)
            errs = {k: _rel(parts[k].double(), x64[k]) for k in parts}
            rows.append({'isolate': name, 'variant': label, **errs})
            print(f'isolate {name}, {label}: vs fp64 '
                  + ', '.join(f'{k} {e:.2e}' for k, e in errs.items()),
                  flush=True)

    twin = C._xl_model(LAYERS, dev).double()
    rows = []
    for step in range(STEPS):
        contribs, mean_grads = [], {}
        for s in range(SHARDS):
            _, _, g, caps = kfac.capture.loss_and_grads(
                loss(y[s:s + 1]), x[s:s + 1])
            contribs.append(dk.local_factor_contribs(caps))
            for n, t in g.items():
                mean_grads[n] = mean_grads.get(n, 0) + t / SHARDS
            del caps, g
        _, _, grads, caps = kfac.capture.loss_and_grads(loss(y), x)
        twin.load_state_dict(model.state_dict())
        twin.zero_grad(set_to_none=True)
        engine.lm_loss(twin(x), y).backward()
        exact = {n: p.grad for n, p in twin.named_parameters()}
        spread = sorted(grads, key=lambda n: -_rel(mean_grads[n], grads[n]))
        for n in spread[:4]:
            rows.append({'step': step, 'grad': n,
                         'mean_vs_full': _rel(mean_grads[n], grads[n]),
                         'full_vs_fp64': _rel(grads[n].double(), exact[n]),
                         'mean_vs_fp64': _rel(mean_grads[n].double(),
                                              exact[n])})
            r = rows[-1]
            print(f"step {step} gradient {n}: 4-sequence mean vs full "
                  f"batch {r['mean_vs_full']:.2e}; against fp64: full "
                  f"{r['full_vs_fp64']:.2e}, mean {r['mean_vs_fp64']:.2e}",
                  flush=True)
        alpha = kfac.factor_decay
        for name in kfac.specs:
            for side in 'AG':
                new = sum(c[name][side] for c in contribs) / SHARDS
                if side == 'G':
                    new = new / SHARDS ** 2
                dist_factors[name][side] = kernels.ema_blend(
                    dist_factors[name][side], new, alpha)
        del contribs
        inv = step % INV_FREQ == 0
        precond, state = kfac.step(state, grads, caps, factor_update=True,
                                   inv_update=inv)
        if inv:
            for name, spec in kfac.specs.items():
                if spec.kind == 'embedding':
                    continue
                ref, mine = state['factors'][name], dist_factors[name]
                g_ref, g_mine = (L.grads_to_matrix(spec, kfac._layer_params(
                    name, gs)) for gs in (grads, mean_grads))
                p32 = [precondition(f['A'], f['G'], g, torch.float32)
                       for f, g in ((ref, g_ref), (mine, g_mine))]
                p64 = [precondition(f['A'], f['G'], g, torch.float64)
                       for f, g in ((ref, g_ref), (mine, g_mine))]
                exact_mat = L.grads_to_matrix(spec, kfac._layer_params(
                    name, exact))
                p_exact = precondition(ref['A'], ref['G'], exact_mat,
                                       torch.float64)
                like = kfac._layer_params(name, grads)
                split = [L.matrix_to_grads(spec, p, like)
                         for p in (*p32, p_exact)]
                for key in like:
                    rows.append({
                        'step': step, 'preconditioned': f'{name}.{key}',
                        'mean_vs_full': _rel(split[1][key], split[0][key]),
                        'full_vs_fp64': _rel(split[0][key].double(),
                                             split[2][key]),
                        'mean_vs_fp64': _rel(split[1][key].double(),
                                             split[2][key])})
                    r = rows[-1]
                    print(f"step {step} preconditioned {name}.{key}: "
                          f"4-sequence path vs full batch "
                          f"{r['mean_vs_full']:.2e}; against fp64 (full "
                          f"batch's factors, fp64 gradient): full "
                          f"{r['full_vs_fp64']:.2e}, mean "
                          f"{r['mean_vs_fp64']:.2e}", flush=True)
                if step == STEPS - 1 and name == ISOLATE:
                    isolate(name, spec, state, ref, mine, grads, mean_grads,
                            exact, like)
                eig = torch.linalg.eigvalsh(ref['A'].double()) + DAMPING
                rows.append({
                    'step': step, 'layer': name,
                    'factor_A': _rel(mine['A'], ref['A']),
                    'factor_G': _rel(mine['G'], ref['G']),
                    'precond_fp32': _rel(p32[1], p32[0]),
                    'precond_fp64': _rel(p64[1], p64[0]),
                    'cond_A': float(eig.max() / eig.min())})
                r = rows[-1]
                print(f"step {step} {name}: factors A {r['factor_A']:.2e} "
                      f"G {r['factor_G']:.2e}; preconditioned, fp32 "
                      f"{r['precond_fp32']:.2e}, fp64 "
                      f"{r['precond_fp64']:.2e}; cond(A + damping) "
                      f"{r['cond_A']:.3g}", flush=True)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= precond[n]
        del grads, mean_grads, exact, caps, precond
    out = ROOT / 'chiprun_out' / 'lm_dist_sensitivity.json'
    out.write_text(json.dumps(rows, indent=1))
    dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
