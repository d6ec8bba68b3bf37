"""fp16 robustness: non-finite capture filtering and dynamic loss scaling
(PyTorch port of ``distributed_kfac_pytorch_tpu/fp16.py``).

Plain functions on tensors, with the JAX package's schedule exactly (not
``torch.amp.GradScaler``, whose schedule has no clip and which unscales
``.grad`` in place):

  - :func:`sanitize_captures` zeroes a whole capture tensor that holds a
    non-finite element, in every stream (``a``, ``g`` and a tied
    embedding's ``a_tied`` / ``g_tied``), and counts the zeroed tensors;
  - :func:`init_loss_scale` / :func:`update_loss_scale`: start at
    ``2**15``, double after 2000 consecutive finite steps, halve on a
    non-finite one, clip to ``[1, 2**24]``; the counter resets on
    overflow and on growth;
  - :func:`apply_if_finite` selects the new or the old tensors of a tree
    on a finiteness flag, on the device.

The training step (``training.engine``) reads the finiteness flag on the
host once per step and skips the update on overflow; the functions here
never sync the host.
"""

from __future__ import annotations

import torch

from distributed_kfac_pytorch_tpu_torch import resolve_device


def _tensor_finite(x: torch.Tensor) -> torch.Tensor:
    """A device bool scalar: every element of ``x`` is finite. One pass
    over ``x`` (its min and max, which a NaN or an infinity carries),
    not ``isfinite(x).all()``'s elementwise passes."""
    if x.numel() == 0:
        return torch.ones((), dtype=torch.bool, device=x.device)
    return torch.isfinite(torch.stack(torch.aminmax(x))).all()


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return []


def tree_all_finite(tree) -> torch.Tensor:
    """A device bool scalar: every element of every tensor of ``tree``
    (nested dicts, lists and tuples) is finite (True for no tensor)."""
    leaves = [t for t in _leaves(tree) if t.is_floating_point()]
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([_tensor_finite(t) for t in leaves]).all()


def sanitize_captures(captures: dict) -> tuple[dict, torch.Tensor]:
    """``(clean_captures, n_zeroed)``: each per-call capture tensor with
    any non-finite element replaced by zeros (the whole tensor, as the
    reference drops the whole batch: a partial mask would bias the
    covariance), in every stream; ``n_zeroed`` is a device int32 count.
    Integer captures (an embedding's ids) pass through."""
    count = None
    out = {}
    for name, entry in captures.items():
        clean = {}
        for key, calls in entry.items():
            kept = []
            for x in calls:
                if not x.is_floating_point():
                    kept.append(x)
                    continue
                ok = _tensor_finite(x)
                bad = (~ok).to(torch.int32)
                count = bad if count is None else count + bad
                kept.append(torch.where(ok, x, 0.0))
            clean[key] = tuple(kept)
        out[name] = clean
    if count is None:
        count = torch.zeros((), dtype=torch.int32)
    return out, count


def init_loss_scale(initial: float = 2.0 ** 15, device='cuda') -> dict:
    """Fresh dynamic-loss-scale state (the AMP defaults): an fp32
    ``scale`` and an int32 ``growth_count``, device scalars on ``device``
    (default ``'cuda'``: raises without a CUDA device unless ``'cpu'`` is
    passed, as every entry point does)."""
    device = resolve_device(device)
    return {'scale': torch.tensor(initial, dtype=torch.float32,
                                  device=device),
            'growth_count': torch.zeros((), dtype=torch.int32,
                                        device=device)}


def update_loss_scale(state: dict, grads_finite,
                      growth_interval: int = 2000,
                      growth_factor: float = 2.0,
                      backoff_factor: float = 0.5,
                      min_scale: float = 1.0,
                      max_scale: float = 2.0 ** 24) -> dict:
    """One step of the schedule (a new state; ``state`` is not changed).

    ``grads_finite``: a bool scalar (a Python bool or a device tensor).
    On overflow the scale backs off and the counter resets; after
    ``growth_interval`` consecutive finite steps the scale grows and the
    counter resets; the scale is clipped to ``[min_scale, max_scale]``.
    The caller skips the update on overflow."""
    scale, count = state['scale'], state['growth_count']
    finite = torch.as_tensor(grads_finite, device=scale.device)
    grew = count + 1
    do_grow = finite & (grew >= growth_interval)
    new_scale = torch.where(
        finite, torch.where(do_grow, scale * growth_factor, scale),
        scale * backoff_factor)
    new_scale = torch.clamp(new_scale, min_scale, max_scale)
    new_count = torch.where(finite & ~do_grow, grew,
                            torch.zeros_like(grew))
    return {'scale': new_scale, 'growth_count': new_count}


def apply_if_finite(grads_finite, new_tree, old_tree):
    """``new_tree`` where ``grads_finite``, else ``old_tree``, tensor by
    tensor on the device (nested dicts, lists and tuples of the same
    structure; a non-tensor leaf is taken from ``new_tree``)."""
    if isinstance(new_tree, torch.Tensor):
        finite = torch.as_tensor(grads_finite, device=new_tree.device)
        return torch.where(finite, new_tree, old_tree)
    if isinstance(new_tree, dict):
        return {k: apply_if_finite(grads_finite, v, old_tree[k])
                for k, v in new_tree.items()}
    if isinstance(new_tree, (list, tuple)):
        return type(new_tree)(apply_if_finite(grads_finite, n, o)
                              for n, o in zip(new_tree, old_tree))
    return new_tree
