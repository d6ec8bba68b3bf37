"""On-device K-FAC step metrics (PyTorch port of
``distributed_kfac_pytorch_tpu/observability/metrics.py``).

The metrics ride in the K-FAC state (``state['metrics']``, present only
with ``KFAC(collect_metrics=True)``), so enabling them changes no call
signature. Every entry is a 0-dim device tensor computed by the step; the
step never reads one on the host, and every update builds new tensors
(nothing is changed in place), so a record that holds them keeps its
step's values. The engine's JSONL sink snapshots them and reads them
later (:mod:`observability.sink`).

Tracked (schema in :data:`METRIC_KEYS`):

  - ``damping`` / ``nu``: the damping and the KL-clip scale of the step;
  - ``grad_norm`` / ``precond_norm``: global l2 norms of the registered
    layers' gradient matrices and of the ``nu``-scaled preconditioned
    ones;
  - ``factor_updates`` / ``inv_updates`` / ``inv_chunk_firings``:
    cumulative counts of factor steps, monolithic inverse firings and
    pipelined chunk firings;
  - ``nonfinite_skips``: factor steps whose candidate factors were not
    all finite (kept out of the state when ``nonfinite_guard`` is on);
  - ``eig_clipped``: stored eigenvalues at the 0.0 clip floor (a clipped
    eigenvalue is stored as exactly 0, so ``d <= 0`` counts them);
  - ``bucket_norms/<shape>``: l2 norm of the preconditioned matrices of
    each gradient-matrix shape (the groups the bucketed precondition
    batches over).

The norms take few launches: one ``torch._foreach_norm`` per side over
every layer's matrix, and one product with a 0/1 matrix the caller keeps
for the per-shape sums (deterministic, unlike an atomic ``index_add_``).
"""

from __future__ import annotations

import torch

# Scalar metric slots (beyond the per-model 'bucket_norms' subtree).
METRIC_KEYS = ('damping', 'nu', 'grad_norm', 'precond_norm',
               'factor_updates', 'inv_updates', 'inv_chunk_firings',
               'nonfinite_skips', 'eig_clipped')
_INT_KEYS = ('factor_updates', 'inv_updates', 'inv_chunk_firings',
             'nonfinite_skips', 'eig_clipped')


def shape_key(shape) -> str:
    """Stable string key for a gradient-matrix shape bucket."""
    return 'x'.join(str(int(s)) for s in shape)


def init_metrics(bucket_keys, device) -> dict:
    """Fresh metrics subtree for ``state['metrics']`` on ``device``."""
    m = {k: torch.zeros((), dtype=torch.int32 if k in _INT_KEYS
                        else torch.float32, device=device)
         for k in METRIC_KEYS}
    m['nu'] = torch.ones((), dtype=torch.float32, device=device)
    m['bucket_norms'] = {k: torch.zeros((), dtype=torch.float32,
                                        device=device)
                         for k in bucket_keys}
    return m


def _bump(counter: torch.Tensor, fired: bool) -> torch.Tensor:
    """``counter + 1`` when ``fired``, else the same tensor (no launch)."""
    return counter + 1 if fired else counter


def update_metrics(prev: dict, *, damping, stats: dict, did_factor,
                   did_inv, factor_finite, eig_clipped,
                   did_chunk=False) -> dict:
    """One metrics-state transition (a new dict of new tensors).

    ``stats`` comes from the preconditioner's ``with_stats`` pass
    (:func:`precond_stats`); ``did_factor`` / ``did_inv`` / ``did_chunk``
    are the step's cadence flags (Python bools: the host drives the
    cadence); ``factor_finite`` is the device flag of the step's candidate
    factors (None off factor steps, where it counts as finite).
    """
    dev = prev['nu'].device
    if isinstance(damping, torch.Tensor):
        damping = damping.to(torch.float32)
    else:
        damping = torch.full((), float(damping), dtype=torch.float32,
                             device=dev)
    skips = prev['nonfinite_skips']
    if did_factor and factor_finite is not None:
        skips = skips + (~factor_finite.bool()).to(torch.int32)
    return {
        'damping': damping,
        'nu': stats['nu'],
        'grad_norm': stats['grad_norm'],
        'precond_norm': stats['precond_norm'],
        'factor_updates': _bump(prev['factor_updates'], bool(did_factor)),
        'inv_updates': _bump(prev['inv_updates'], bool(did_inv)),
        'inv_chunk_firings': _bump(prev['inv_chunk_firings'],
                                   bool(did_chunk)),
        'nonfinite_skips': skips,
        'eig_clipped': eig_clipped.to(torch.int32),
        'bucket_norms': dict(stats['bucket_norms']),
    }


def flatten_metrics(m: dict, prefix: str = 'kfac') -> dict:
    """Flatten a metrics subtree into scalar entries for a metrics dict
    (``'kfac/grad_norm'``, ``'kfac/bucket_norm/128x65'``, ...)."""
    out = {f'{prefix}/{k}': m[k] for k in METRIC_KEYS if k in m}
    for k, v in m.get('bucket_norms', {}).items():
        out[f'{prefix}/bucket_norm/{k}'] = v
    return out


def _count_nonpositive(parts: list, device) -> torch.Tensor:
    """int32 count of the entries ``<= 0`` over ``parts`` (flat tensors
    of one dtype)."""
    if not parts:
        return torch.zeros((), dtype=torch.int32, device=device)
    flat = torch.cat(parts) if len(parts) > 1 else parts[0]
    return (flat <= 0).sum(dtype=torch.int32)


def count_clipped_eigvals(inverses: dict, device) -> torch.Tensor:
    """Eigenvalues at the 0.0 clip floor in a per-layer inverse dict (the
    ``dA`` / ``dG`` slots; a clipped eigenvalue is stored as exactly 0,
    values above the floor stay positive)."""
    return _count_nonpositive(
        [e[k].reshape(-1) for e in inverses.values() for k in ('dA', 'dG')
         if k in e], device)


def count_clipped_eigvals_stacks(inv_stacks: dict, device,
                                 held: dict | None = None) -> torch.Tensor:
    """Row-local clipped-eigenvalue count over ``DistributedKFAC``'s row
    stacks (the caller sums it over the rows). ``held`` maps a stack's key
    to the device index of the slots that hold a layer of this row: after
    a firing the other slots (padding, layers placed on other rows) hold
    zeros, which ``d <= 0`` would count. Without ``held`` every slot
    counts."""
    parts = []
    for dim, entry in inv_stacks.items():
        if 'd' not in entry:
            continue
        d = entry['d']
        if held is not None:
            idx = held.get(dim)
            if idx is None or idx.numel() == 0:
                continue
            d = d[idx]
        parts.append(d.reshape(-1))
    return _count_nonpositive(parts, device)


def factors_finite(factors: dict) -> torch.Tensor:
    """A device bool: every factor of ``{layer: {side: tensor}}`` is
    finite, from one ``torch._foreach_norm`` over them (a NaN or an
    infinity makes a norm non-finite). The detection flag of the metrics
    when ``nonfinite_guard`` is off; the guard keeps its own exact flag."""
    leaves = [t for e in factors.values() for t in e.values()]
    return torch.isfinite(torch.stack(torch._foreach_norm(leaves))).all()


def _bucket_matrix(keys: tuple, device, cache: dict | None
                   ) -> tuple[list, torch.Tensor]:
    """The bucket order (first appearance) and the ``(B, L)`` 0/1 fp32
    matrix that sums per-layer values into their buckets, kept in
    ``cache`` between steps (building it copies it to the device)."""
    cache_key = (str(device), keys)
    hit = cache.get(cache_key) if cache is not None else None
    if hit is None:
        order = list(dict.fromkeys(keys))
        onehot = torch.zeros((len(order), len(keys)), dtype=torch.float32)
        for i, k in enumerate(keys):
            onehot[order.index(k), i] = 1.0
        hit = (order, onehot.to(device))
        if cache is not None:
            cache[cache_key] = hit
    return hit


def _squared_norms(mats: list) -> torch.Tensor:
    norms = torch.stack([n.float() for n in torch._foreach_norm(mats)])
    return norms * norms


def precond_stats(grad_mats: dict, precond_mats: dict, nu,
                  cache: dict | None = None) -> dict:
    """Norm statistics of one step's precondition pass: ``nu``, the
    gradient and preconditioned (``nu``-scaled) global norms and the
    per-shape-bucket norms. ``grad_mats`` / ``precond_mats`` map layer
    name -> matrix; the buckets group by gradient-matrix shape, in
    registration order. Reads the matrices, writes nothing back.
    ``cache``: a dict the caller keeps (one per preconditioner) for the
    bucket matrix, so steps after the first copy nothing to the device."""
    names = list(grad_mats)
    nu32 = nu.to(torch.float32)
    gsq = _squared_norms([grad_mats[n] for n in names])
    vsq = _squared_norms([precond_mats[n] for n in names]) * (nu32 * nu32)
    order, onehot = _bucket_matrix(
        tuple(shape_key(grad_mats[n].shape) for n in names), nu32.device,
        cache)
    buckets = torch.sqrt(onehot @ vsq)
    return {'nu': nu32,
            'grad_norm': torch.sqrt(gsq.sum()),
            'precond_norm': torch.sqrt(vsq.sum()),
            'bucket_norms': dict(zip(order, buckets.unbind()))}
