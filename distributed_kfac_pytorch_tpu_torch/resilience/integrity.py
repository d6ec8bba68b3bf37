"""Checkpoint-bundle content integrity: a digest stamped at save and
verified at restore (PyTorch port of
``distributed_kfac_pytorch_tpu/resilience/integrity.py``).

  - :func:`tree_checksum` reduces a bundle tree (nested dicts, lists and
    tuples of torch tensors and Python scalars) to one 63-bit digest:
    sha256 over every leaf's path, then a tensor's shape, dtype and raw
    bytes, or a scalar's ``repr``, in a fixed path order (dict keys
    sorted by ``repr``).
  - ``training.checkpoint.bundle_state`` stamps it into the bundle's
    ``scalars`` under :data:`CHECKSUM_KEY`; the ``CheckpointManager``
    stamps each file it writes the same way and verifies each file it
    reads (:class:`ChecksumMismatch`), and :func:`verify_tree` checks a
    restored tree.
  - A flipped byte in any tensor payload restores to other bytes, hence
    another digest; the resume walk (``resilience.cli.resume``)
    quarantines such a bundle and walks back to the newest one that
    verifies.
  - :func:`finite_ok` checks that a restored K-FAC state holds no NaN or
    infinity: a bundle saved after the state was poisoned verifies, and
    the self-healing rollback walk (``resilience.selfheal``) must pass it.

The digest is the port's own: it need not equal the JAX package's for the
same model (NCHW against NHWC layouts, the ``(c, kh, kw)`` conv basis
against ``(kh, kw, c)``); the same tree gives the same digest, and one
changed byte gives another.
"""

from __future__ import annotations

import hashlib

import torch

#: Key of the content digest inside ``bundle['scalars']``.
CHECKSUM_KEY = 'integrity_checksum'
#: Sentinel digest: "recorded as unverifiable" (a restore template),
#: distinct from the field being absent (a bundle without integrity).
UNVERIFIED = 0

_SCALARS = (bool, int, float, str, type(None))


class ChecksumMismatch(ValueError):
    """A bundle file whose content does not hash to its recorded digest."""


def _walk(tree, path: str = ''):
    """``(path, leaf)`` of every leaf in the fixed order."""
    if isinstance(tree, dict):
        for key in sorted(tree, key=repr):
            yield from _walk(tree[key], f'{path}[{key!r}]')
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _walk(item, f'{path}[{i}]')
    else:
        yield path, tree


def _leaf_update(h, path: str, leaf) -> None:
    h.update(path.encode())
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to('cpu').contiguous().reshape(-1)
        h.update(f'{tuple(leaf.shape)}{leaf.dtype}'.encode())
        h.update(t.view(torch.uint8).numpy())
    elif isinstance(leaf, _SCALARS):
        h.update(repr(leaf).encode())
    else:
        raise TypeError(f'bundle leaf {path} of type '
                        f'{type(leaf).__name__} is not a tensor or a '
                        'Python scalar')


def tree_checksum(tree) -> int:
    """63-bit content digest of a bundle tree; the ``scalars``'
    :data:`CHECKSUM_KEY` leaf is left out (the digest cannot cover
    itself)."""
    h = hashlib.sha256()
    skip = f"[{CHECKSUM_KEY!r}]"
    for path, leaf in _walk(tree):
        if path.endswith(skip):
            continue
        _leaf_update(h, path, leaf)
    digest = int.from_bytes(h.digest()[:8], 'big') & ((1 << 63) - 1)
    # The real digest must never read as the sentinel.
    return digest or 1


def stamp(tree: dict, compute: bool = True) -> dict:
    """Record the digest into ``tree['scalars']`` (in place; returns the
    tree). ``compute=False`` records :data:`UNVERIFIED` without hashing,
    for restore templates."""
    scalars = tree.get('scalars')
    if isinstance(scalars, dict):
        scalars[CHECKSUM_KEY] = (tree_checksum(tree) if compute
                                 else UNVERIFIED)
    return tree


def recorded_checksum(tree: dict):
    """The digest recorded in a restored bundle: an int, or None for a
    bundle without the field."""
    scalars = tree.get('scalars', {})
    if CHECKSUM_KEY not in scalars:
        return None
    return int(scalars[CHECKSUM_KEY])


def verify_tree(tree: dict) -> tuple[bool | None, int | None, int]:
    """Verify a restored bundle against its recorded digest: ``(ok,
    recorded, actual)``, ``ok`` None when the bundle carries no digest or
    :data:`UNVERIFIED` (restored with a warning, not quarantined)."""
    recorded = recorded_checksum(tree)
    if recorded is None or recorded == UNVERIFIED:
        return None, recorded, UNVERIFIED
    actual = tree_checksum(tree)
    return recorded == actual, recorded, actual


def finite_ok(subtree) -> bool:
    """True when every floating-point tensor of ``subtree`` (nested dicts,
    lists and tuples) is finite; bf16 and fp16 are widened to fp32 for
    the check. One host read per tensor."""
    for _path, leaf in _walk(subtree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                and leaf.numel():
            if not bool(torch.isfinite(leaf.float()).all()):
                return False
    return True


def strip_checksum(like: dict) -> dict:
    """The same tree without ``scalars[CHECKSUM_KEY]`` (the form of a
    bundle saved without integrity)."""
    if not isinstance(like, dict) or 'scalars' not in like:
        return like
    scalars = {k: v for k, v in like['scalars'].items()
               if k != CHECKSUM_KEY}
    return {**like, 'scalars': scalars}


def describe_mismatch(recorded: int | None, actual: int) -> str:
    if recorded is None:
        return 'bundle predates content checksums'
    if recorded == UNVERIFIED:
        return 'bundle recorded no digest'
    return (f'content digest mismatch: recorded {recorded:#x}, '
            f'restored data hashes to {actual:#x}')
