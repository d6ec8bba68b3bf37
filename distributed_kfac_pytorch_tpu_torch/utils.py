"""Tracing and memory-accounting utilities (PyTorch port of
``distributed_kfac_pytorch_tpu/utils.py``).

The trace table lives in :mod:`observability.tracing`; its names are
re-exported here (the same objects, one table). The JAX module's
compilation-cache and XLA-flag helpers have no torch counterpart.
"""

from __future__ import annotations

from typing import Any

import torch

from distributed_kfac_pytorch_tpu_torch.observability.tracing import (  # noqa: F401
    _FUNC_TRACES,
    clear_trace,
    get_trace,
    print_trace,
    trace,
)


def tree_bytes(tree: Any) -> int:
    """Total bytes of every tensor in ``tree`` (nested dicts, lists and
    tuples of tensors; other leaves count nothing)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0
