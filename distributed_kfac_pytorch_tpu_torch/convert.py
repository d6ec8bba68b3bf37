"""Conversion between the JAX package's parameters / K-FAC state and the
port's (no JAX counterpart).

Inputs and outputs are nested dicts of numpy arrays on the JAX side and
flat ``state_dict``-style dicts of tensors on the torch side, so neither
framework has to import the other. Layout rules:

  - flax module path ``a/b`` is torch module name ``a.b``;
  - conv kernel HWIO -> weight OIHW: ``transpose(3, 2, 0, 1)``;
  - Dense kernel ``(in, out)`` -> weight ``(out, in)``;
  - ``Embed.embedding`` ``(vocab, dim)`` -> ``nn.Embedding.weight`` as is;
  - BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
    ``weight``/``bias``/``running_mean``/``running_var``. Values are
    copied as they are: flax keeps the biased batch variance in ``var``
    and torch the unbiased one in ``running_var``, so running statistics
    accumulated by the two frameworks differ by ``n/(n-1)`` per update;
  - LayerNorm ``scale``/``bias`` (no batch stats) -> ``weight``/``bias``;
  - a parameter a module declares itself (``self.param``; e.g. the
    Transformer LM's top-level ``pos_embed``) keeps its name under the
    module's path;
  - a conv A factor's basis ``(kh, kw, c)`` -> ``(c, kh, kw)``
    (:func:`conv_a_perm`), for the factor, a baked ``A_inv`` and the rows
    of an eigenbasis ``QA``; a grouped conv's ``(G, da, da)`` A stacks
    the same way within each block (``(kh, kw, cpg)`` -> ``(cpg, kh,
    kw)``, the identity for a depthwise conv); G sides and Linear factors
    need no change. A grouped kernel ``(kh, kw, cpg, cout)`` is a weight
    ``(cout, cpg, kh, kw)`` by the conv rule above;
  - bf16 arrays (``ml_dtypes.bfloat16`` on the JAX side) cross as their
    16-bit patterns, exactly (:func:`array_to_tensor`).
"""

from __future__ import annotations

import numpy as np
import torch


def _walk(tree: dict, path: tuple = ()):
    """Yield ``(module path, {leaf name: array})`` for every module that
    holds arrays directly."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    if leaves:
        yield path, leaves
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))


def flax_to_torch(params: dict, batch_stats: dict | None = None
                  ) -> dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) -> torch ``state_dict``."""
    stats = {p: leaves for p, leaves in _walk(batch_stats or {})}
    out: dict[str, torch.Tensor] = {}
    for path, leaves in _walk(params):
        name = '.'.join(path)
        t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa
        if not path or not {'embedding', 'scale', 'kernel'} & set(leaves):
            for leaf, value in leaves.items():        # own parameters
                out['.'.join((*path, leaf))] = t(value)
            continue
        if 'embedding' in leaves:                     # Embed
            out[f'{name}.weight'] = t(leaves['embedding'])
            continue
        if 'scale' in leaves:                         # BatchNorm, LayerNorm
            out[f'{name}.weight'] = t(leaves['scale'])
            out[f'{name}.bias'] = t(leaves['bias'])
            if path in stats:
                out[f'{name}.running_mean'] = t(stats[path]['mean'])
                out[f'{name}.running_var'] = t(stats[path]['var'])
                out[f'{name}.num_batches_tracked'] = torch.tensor(0)
            continue
        kernel = np.asarray(leaves['kernel'])
        if kernel.ndim == 4:                          # Conv HWIO -> OIHW
            out[f'{name}.weight'] = t(kernel.transpose(3, 2, 0, 1))
        elif kernel.ndim == 2:                        # Dense (in, out)
            out[f'{name}.weight'] = t(kernel.T)
        else:
            raise ValueError(f'{name}: unsupported kernel shape '
                             f'{kernel.shape}')
        if 'bias' in leaves:
            out[f'{name}.bias'] = t(leaves['bias'])
    return out


def torch_to_flax(state_dict: dict, embeddings=()) -> tuple[dict, dict]:
    """Inverse of :func:`flax_to_torch`: ``(params, batch_stats)``.

    ``embeddings`` names the ``nn.Embedding`` modules: a state dict alone
    does not tell an embedding table from a bias-free Dense weight.
    A top-level name such as ``pos_embed`` is a parameter the model
    declares itself, kept as it is.
    A 1-D ``weight`` without running statistics is a LayerNorm scale.
    """
    params: dict = {}
    stats: dict = {}

    def put(tree, path, key, value):
        for part in path:
            tree = tree.setdefault(part, {})
        tree[key] = value

    own = {k for k in state_dict if '.' not in k}
    for key in own:
        *path, leaf = key.split('.')
        put(params, tuple(path), leaf,
            state_dict[key].detach().cpu().numpy())
    names = sorted({k.rsplit('.', 1)[0] for k in state_dict
                    if k not in own})
    for name in names:
        path = tuple(name.split('.'))
        leaf = lambda k: state_dict[f'{name}.{k}'].detach().cpu().numpy()  # noqa
        if f'{name}.running_mean' in state_dict:      # BatchNorm
            put(params, path, 'scale', leaf('weight'))
            put(params, path, 'bias', leaf('bias'))
            put(stats, path, 'mean', leaf('running_mean'))
            put(stats, path, 'var', leaf('running_var'))
            continue
        w = leaf('weight')
        if name in embeddings:
            put(params, path, 'embedding', w)
            continue
        if w.ndim == 1:                               # LayerNorm
            put(params, path, 'scale', w)
            put(params, path, 'bias', leaf('bias'))
            continue
        put(params, path, 'kernel',
            w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T)
        if f'{name}.bias' in state_dict:
            put(params, path, 'bias', leaf('bias'))
    return params, stats


def load_flax_params(model: torch.nn.Module, params: dict,
                     batch_stats: dict | None = None) -> torch.nn.Module:
    """Load flax ``params`` (+ ``batch_stats``) into the port's twin of
    the flax model, every parameter and buffer matched by name
    (``strict``): e.g. a JAX ``TransformerLM``'s parameters, tied or
    untied, into :class:`models.transformer_lm.TransformerLM`."""
    model.load_state_dict(flax_to_torch(params, batch_stats))
    return model


def conv_a_perm(kernel_size, cin: int, has_bias: bool = False
                ) -> np.ndarray:
    """Index map of a conv A factor from the JAX ``(kh, kw, c)`` basis to
    the port's ``(c, kh, kw)`` one: ``A_torch = A_jax[perm][:, perm]``
    (a bias row/column stays last)."""
    kh, kw = kernel_size
    c, i, j = np.meshgrid(np.arange(cin), np.arange(kh), np.arange(kw),
                          indexing='ij')
    perm = ((i * kw + j) * cin + c).reshape(-1)
    if has_bias:
        perm = np.append(perm, kh * kw * cin)
    return perm


def array_to_tensor(a) -> torch.Tensor:
    """A JAX-side array (numpy, or anything ``np.asarray`` takes) as a CPU
    tensor: bf16 stays bf16, anything else becomes fp32.

    The JAX package's bf16 arrays are ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects (and the card's machine has no
    ``ml_dtypes``), so they are recognised by the dtype's name and carried
    over as their 16-bit patterns, exactly."""
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':
        bits = np.ascontiguousarray(a).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, np.float32))


def tensor_to_array(t: torch.Tensor, bfloat16=None) -> np.ndarray:
    """Inverse of :func:`array_to_tensor`: a tensor as a numpy array; a bf16
    tensor as its 16-bit patterns (``uint16``), viewed as ``bfloat16``
    when that numpy dtype is given (e.g. ``jnp.bfloat16`` on the JAX
    side)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    bits = t.contiguous().view(torch.uint16).numpy().copy()
    return bits if bfloat16 is None else bits.view(bfloat16)


def _a_perm(spec, a_dim: int) -> np.ndarray | None:
    """The conv A basis map of layer ``spec`` (:func:`conv_a_perm`) for an
    A of dimension ``a_dim`` (a grouped conv: one block's); None for the
    other kinds."""
    if spec.kind not in ('conv2d', 'conv2d_grouped'):
        return None
    kh, kw = spec.kernel_size
    cin = (a_dim - int(spec.has_bias)) // (kh * kw)
    return conv_a_perm(spec.kernel_size, cin, spec.has_bias)


def _map_a_side(key: str, a: np.ndarray, perm) -> np.ndarray:
    """Reorder an A-side slot by ``perm``: a matrix (the factor, a baked
    inverse; each block of a grouped stack) on its last two axes, an
    eigenbasis on its rows only; eigenvalues and diagonal slots (1-D) as
    they are."""
    if perm is None or a.ndim == 1:
        return a
    rows = a[..., perm, :]
    return rows if key.startswith('Q') else rows[..., perm]


def _convert_state(tree: dict, specs: dict, to_torch: bool,
                   bfloat16=None) -> dict:
    """A factor or inverse dict from one framework's keys and A basis to
    the other's (:func:`jax_factors_to_torch` and its kin)."""
    out = {}
    for name, entry in tree.items():
        tname = name.replace('/', '.')
        spec = specs[tname]
        mapped = {}
        for key, value in entry.items():
            a = (np.asarray(value) if to_torch
                 else tensor_to_array(value, bfloat16))
            if key.endswith('A') or key.startswith('A'):
                dim = a.shape[-2] if a.ndim > 1 else a.shape[0]
                perm = _a_perm(spec, dim)
                if perm is not None and not to_torch:
                    perm = np.argsort(perm)
                a = _map_a_side(key, a, perm)
            mapped[key] = array_to_tensor(a) if to_torch else a
        out[tname if to_torch else name] = mapped
    return out


def jax_factors_to_torch(factors: dict, specs: dict) -> dict:
    """JAX K-FAC ``state['factors']`` (keyed by flax path ``a/b``) -> the
    port's (keyed by ``a.b``), conv A factors permuted into ``(c, kh,
    kw)``; bf16 factors (``factor_dtype``) stay bf16, bit for bit
    (:func:`array_to_tensor`). ``specs`` are the port's ``KFAC.specs``.
    A state's ``factor_accum`` and ``frozen_factors`` have the factors'
    layout and convert the same way (:func:`jax_state_to_torch`)."""
    return _convert_state(factors, specs, to_torch=True)


def jax_inverses_to_torch(inverses: dict, specs: dict) -> dict:
    """JAX K-FAC ``state['inverses']`` -> the port's: eigen slots (``QA``,
    ``dA``, ``QG``, ``dG``), baked ``A_inv`` / ``G_inv`` and an
    embedding's diagonal ``A_inv``, conv A bases into ``(c, kh, kw)`` (an
    eigenbasis on its rows: its eigenvalue order is kept); bf16
    (``inv_dtype``) stays bf16, bit for bit."""
    return _convert_state(inverses, specs, to_torch=True)


def torch_factors_to_jax(factors: dict, specs: dict, bfloat16=None
                         ) -> dict:
    """Inverse of :func:`jax_factors_to_torch`, keyed by the flax path
    ``a/b``; bf16 tensors as :func:`tensor_to_array` gives them."""
    return _convert_state({n.replace('.', '/'): e
                           for n, e in factors.items()}, specs,
                          to_torch=False, bfloat16=bfloat16)


def torch_inverses_to_jax(inverses: dict, specs: dict, bfloat16=None
                          ) -> dict:
    """Inverse of :func:`jax_inverses_to_torch`."""
    return _convert_state({n.replace('.', '/'): e
                           for n, e in inverses.items()}, specs,
                          to_torch=False, bfloat16=bfloat16)


#: Entries of a K-FAC state laid out as its factors: the factors, the
#: deferred-reduction accumulator and the stale-firing snapshot.
FACTOR_LAYOUT_KEYS = ('factors', 'factor_accum', 'frozen_factors')


def jax_state_to_torch(state: dict, specs: dict) -> dict:
    """A single-device JAX ``KFAC`` state -> the port's ``KFAC`` state: the
    factor-layout entries (:data:`FACTOR_LAYOUT_KEYS`, each present one)
    through :func:`jax_factors_to_torch`, conv A bases permuted; the
    inverses through :func:`jax_inverses_to_torch`; ``step``,
    ``inv_chunk_phase`` as ints and ``accum_decay`` as an fp32 scalar
    tensor. Tensors are on the CPU."""
    out = {'step': int(np.asarray(state['step'])),
           'inv_chunk_phase': int(np.asarray(state.get('inv_chunk_phase',
                                                       0)))}
    for key in FACTOR_LAYOUT_KEYS:
        if key in state:
            out[key] = jax_factors_to_torch(state[key], specs)
    if 'inverses' in state:
        out['inverses'] = jax_inverses_to_torch(state['inverses'], specs)
    if 'accum_decay' in state:
        out['accum_decay'] = torch.tensor(
            float(np.asarray(state['accum_decay'])), dtype=torch.float32)
    return out


def torch_state_to_jax(state: dict, specs: dict, bfloat16=None) -> dict:
    """Inverse of :func:`jax_state_to_torch` (numpy arrays keyed by flax
    path; ``step``, ``inv_chunk_phase`` int32 and ``accum_decay`` fp32
    scalars)."""
    out = {'step': np.int32(state['step']),
           'inv_chunk_phase': np.int32(state.get('inv_chunk_phase', 0))}
    for key in FACTOR_LAYOUT_KEYS:
        if key in state:
            out[key] = torch_factors_to_jax(state[key], specs, bfloat16)
    if 'inverses' in state:
        out['inverses'] = torch_inverses_to_jax(state['inverses'], specs,
                                                bfloat16)
    if 'accum_decay' in state:
        out['accum_decay'] = np.float32(float(state['accum_decay']))
    return out
