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
    (:func:`conv_a_perm`); G factors and Linear factors need no change.
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


def jax_factors_to_torch(factors: dict, specs: dict) -> dict:
    """JAX K-FAC ``state['factors']`` (keyed by flax path ``a/b``) -> the
    port's (keyed by ``a.b``), conv A factors permuted into ``(c, kh,
    kw)``. ``specs`` are the port's ``KFAC.specs``."""
    out = {}
    for jname, f in factors.items():
        name = jname.replace('/', '.')
        spec = specs[name]
        a = np.asarray(f['A'])
        if spec.kind == 'conv2d':
            kh, kw = spec.kernel_size
            cin = (a.shape[0] - int(spec.has_bias)) // (kh * kw)
            p = conv_a_perm(spec.kernel_size, cin, spec.has_bias)
            a = a[p][:, p]
        out[name] = {'A': torch.from_numpy(np.array(a, np.float32)),
                     'G': torch.from_numpy(np.array(f['G'], np.float32))}
    return out
