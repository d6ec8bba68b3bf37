"""Sequence parallelism and the chunked attention fold of the torch port
against the JAX package (``parallel/sequence.py``, the Transformer LM's
``attn_block_size`` and sequence group).

  - ``chunked_causal_attention``, forward and ``q/k/v`` gradients, at a
    length the block divides, ragged lengths and ``T <= block``, causal
    and not, against JAX's (``jax.grad`` through its checkpointed scan);
  - the tiny Transformer (2 blocks, d 32, 4 heads, sequence 16) with and
    without ``attn_block_size``: logits and parameter gradients against
    the JAX model with the same knob;
  - ``ring_self_attention`` on 2- and 4-rank gloo worlds of subprocesses
    (``test_torch_distributed``'s launcher; the children never import
    JAX), forward and gradients after every rank's ``backward``, against
    JAX's ring under ``shard_map`` on a ``SEQ_AXIS`` mesh of as many
    virtual CPU devices and against the port's ``local_causal_attention``
    on the whole sequence;
  - the tiny Transformer sharded over the ranks with ``pos_offset``: each
    rank's logits and the world's mean of the parameter gradients against
    the unsharded JAX model (JAX's
    ``test_transformer_ring_matches_single_device``, with gradients).

The world's children import this module, so JAX is imported inside the
functions that run here only.

Tolerances, relative to the largest reference entry: outputs and logits
<= 1e-5, gradients <= 1e-4 (per tensor; a key projection's bias, whose
gradient is 0 in exact arithmetic, against its weight's largest entry).
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from distributed_kfac_pytorch_tpu_torch import convert, launch
from distributed_kfac_pytorch_tpu_torch.models import transformer_lm
from distributed_kfac_pytorch_tpu_torch.parallel import sequence
from distributed_kfac_pytorch_tpu_torch.training import engine
from test_torch_distributed import _finish_world, _start_world

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
B, T, H, HD = 2, 16, 2, 4                  # attention operands
VOCAB, D, HEADS, LAYERS = 29, 32, 4, 2     # the tiny Transformer
WORLDS = (2, 4)
CAUSAL = (True, False)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, ref, scale=None) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if scale is None:
        scale = np.max(np.abs(ref))
    return float(np.max(np.abs(got - ref)) / max(float(scale), 1e-30))


def _grad_scale(name: str, ref: dict):
    """The scale a parameter gradient is held against: its own largest
    entry, a key projection's bias its weight's."""
    if name.endswith('k_proj.bias'):
        return np.max(np.abs(ref[name[:-len('bias')] + 'weight']))
    return None


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, HD)).astype(np.float32)
            for _ in range(4)]                 # q, k, v, loss weights


def _lm_batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (B, T)).astype(np.int32),
            rng.integers(0, VOCAB, (B, T)).astype(np.int32))


def _jax_lm(**kw):
    from distributed_kfac_pytorch_tpu.models import transformer_lm as jtl
    return jtl.TransformerLM(vocab_size=VOCAB, d_model=D,
                             num_layers=LAYERS, num_heads=HEADS, max_len=T,
                             dropout=0.0, tie_weights=True, **kw)


def _torch_lm(params, **kw):
    model = transformer_lm.TransformerLM(
        VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS, max_len=T,
        dropout=0.0, tie_weights=True, **kw)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in params.items()})
    return model


def _jax_lm_reference(flax_params, ids, targets):
    """The unsharded JAX model's logits and mean-loss parameter gradients
    (torch names)."""
    import jax
    import jax.numpy as jnp
    model = _jax_lm()

    def loss(p):
        logits = model.apply({'params': p}, jnp.asarray(ids), train=False)
        logp = jax.nn.log_softmax(logits, axis=-1)
        xent = -jnp.take_along_axis(logp, jnp.asarray(targets)[..., None],
                                    -1).mean()
        return xent, logits

    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(flax_params)
    return np.asarray(logits), {
        k: v.numpy() for k, v in convert.flax_to_torch(
            jax.tree.map(np.asarray, grads)).items()}


def _attention_grads(fn, q, k, v, w):
    """``fn(q, k, v)`` and the gradients of ``sum(fn * w)`` (torch)."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(q, k, v)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [a.grad.numpy() for a in (q, k, v)]


# ---------------------------------------------------------------------------
# The chunked fold on one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('causal', CAUSAL)
@pytest.mark.parametrize('block', [4, 5, 7, 16, 32],
                         ids=['divides', 'ragged5', 'ragged7', 'equal',
                              'longer'])
def test_chunked_attention_matches_jax(block, causal):
    import jax
    import jax.numpy as jnp

    from distributed_kfac_pytorch_tpu.parallel import sequence as jseq
    q, k, v, w = _operands()

    def jax_fn(q, k, v):
        return jseq.chunked_causal_attention(q, k, v, block_size=block,
                                             causal=causal)

    ref = jax_fn(*map(jnp.asarray, (q, k, v)))
    ref_grads = jax.grad(lambda q, k, v: jnp.sum(jax_fn(q, k, v) * w),
                         argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got, grads = _attention_grads(
        lambda q, k, v: sequence.chunked_causal_attention(
            q, k, v, block_size=block, causal=causal), q, k, v, w)
    assert _rel(got, ref) <= OUT_TOL
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= GRAD_TOL


def test_chunked_attention_recomputes_each_fold(monkeypatch):
    """Each fold runs under ``torch.utils.checkpoint``: the backward pass
    runs the block attention again, once per block."""
    q, k, v, w = _operands()
    calls = []
    real = sequence._block_attend

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(sequence, '_block_attend', counting)
    _attention_grads(lambda q, k, v: sequence.chunked_causal_attention(
        q, k, v, block_size=5), q, k, v, w)
    assert len(calls) == 2 * 4          # 4 blocks, forward and recompute


@pytest.mark.parametrize('block', [None, 4, 5])
def test_transformer_attn_block_size_matches_jax(block):
    import jax
    import jax.numpy as jnp
    ids, targets = _lm_batch()
    variables = _jax_lm().init(jax.random.PRNGKey(0), jnp.asarray(ids),
                               train=False)
    flax_params = variables['params']
    model_j = _jax_lm(attn_block_size=block)

    def loss(p):
        logits = model_j.apply({'params': p}, jnp.asarray(ids), train=False)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(targets)[..., None],
                                    -1).mean(), logits

    (_, ref), ref_grads = jax.value_and_grad(loss, has_aux=True)(
        flax_params)
    ref_grads = {k: v.numpy() for k, v in convert.flax_to_torch(
        jax.tree.map(np.asarray, ref_grads)).items()}
    params = convert.flax_to_torch(jax.tree.map(np.asarray, flax_params))
    model = _torch_lm(params, attn_block_size=block)
    logits = model(torch.from_numpy(ids).long())
    engine.lm_loss(logits, torch.from_numpy(targets).long()).backward()
    assert _rel(logits.detach().numpy(), ref) <= OUT_TOL
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), ref_grads[name],
                    _grad_scale(name, ref_grads)) <= GRAD_TOL, name


def test_ring_and_block_size_are_exclusive():
    with pytest.raises(ValueError, match='mutually exclusive'):
        transformer_lm.TransformerLM(VOCAB, d_model=D, num_layers=1,
                                     num_heads=HEADS, max_len=T,
                                     attn_block_size=4, seq_group=object())
    with pytest.raises(ValueError, match='mutually exclusive'):
        transformer_lm.get_model(VOCAB, 'tiny', attn_block_size=4,
                                 seq_group=object())


def test_local_tile_without_a_group():
    assert launch.process_local_tile(4, 8) == (slice(0, 4), slice(0, 8))
    with pytest.raises(ValueError, match='does not divide'):
        launch.process_local_tile(4, 8, seq_parallel=2)


# ---------------------------------------------------------------------------
# The ring on gloo worlds
# ---------------------------------------------------------------------------

def worker_main():
    """One rank (``test_torch_distributed._start_world``): the ring over
    the whole world, attention alone and the tiny Transformer."""
    import torch.distributed as dist

    cfg = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    meta = launch.initialize_distributed(
        init_method=f'file://{cfg["store"]}', device='cpu', timeout=120)
    rank, world = meta['process_index'], meta['process_count']
    data = np.load(cfg['data'])
    group = sequence.make_sequence_group(world)
    rows, cols = launch.process_local_tile(B, T, world)
    out = {'group_size': np.asarray(dist.get_world_size(group))}
    q, k, v, w = (data[n][:, cols] for n in 'qkvw')
    for causal in CAUSAL:
        got, grads = _attention_grads(
            lambda q, k, v: sequence.ring_self_attention(
                q, k, v, group=group, causal=causal), q, k, v, w)
        out[f'attn/{causal}/out'] = got
        for n, g in zip('qkv', grads):
            out[f'attn/{causal}/grad/{n}'] = g
    params = {key[len('p/'):]: data[key] for key in data.files
              if key.startswith('p/')}
    model = _torch_lm(params, seq_group=group)
    ids, targets = (torch.from_numpy(data[n][rows, cols]).long()
                    for n in ('ids', 'targets'))
    logits = model(ids, pos_offset=cols.start)
    engine.lm_loss(logits, targets).backward()
    names = [n for n, _ in model.named_parameters()]
    means = engine.world_mean([p.grad for _, p in model.named_parameters()])
    out['lm/logits'] = logits.detach().numpy()
    out.update({f'lm/grad/{n}': g.numpy() for n, g in zip(names, means)})
    leaked = [m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'optax')]
    out['jax_modules'] = np.asarray(len(leaked))
    np.savez(pathlib.Path(cfg['out']) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


def _jax_ring(s, causal, q, k, v, w):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from distributed_kfac_pytorch_tpu.parallel import sequence as jseq
    mesh = Mesh(np.asarray(jax.devices()[:s]), (jseq.SEQ_AXIS,))
    spec = P(None, jseq.SEQ_AXIS)
    ring = jax.shard_map(
        lambda q, k, v: jseq.ring_self_attention(q, k, v, causal=causal),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    args = tuple(map(jnp.asarray, (q, k, v)))
    out = jax.jit(ring)(*args)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) * w),
                             argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope='module')
def rings(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    tmp = tmp_path_factory.mktemp('ring_worlds')
    q, k, v, w = _operands()
    ids, targets = _lm_batch()
    flax_params = _jax_lm().init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                 train=False)['params']
    params = {n: t.numpy() for n, t in convert.flax_to_torch(
        jax.tree.map(np.asarray, flax_params)).items()}
    data = tmp / 'data.npz'
    np.savez(data, q=q, k=k, v=v, w=w, ids=ids, targets=targets,
             **{f'p/{n}': t for n, t in params.items()})
    worlds = {s: _start_world(tmp, s, [], data, module='test_torch_sequence')
              for s in WORLDS}
    try:
        jax_ring = {(s, c): _jax_ring(s, c, q, k, v, w)
                    for s in WORLDS for c in CAUSAL}
        local = {c: _attention_grads(
            lambda q, k, v, c=c: sequence.local_causal_attention(
                q, k, v, causal=c), q, k, v, w) for c in CAUSAL}
        lm = _jax_lm_reference(flax_params, ids, targets)
    finally:
        ranks = {s: _finish_world(p, tmp, s) for s, p in worlds.items()}
    return {'ranks': ranks, 'jax_ring': jax_ring, 'local': local, 'lm': lm}


def _blocks(s, rank):
    t = T // s
    return slice(rank * t, (rank + 1) * t)


def test_children_never_import_jax(rings):
    assert all(int(r['jax_modules']) == 0
               for rs in rings['ranks'].values() for r in rs)
    assert all(int(r['group_size']) == s
               for s, rs in rings['ranks'].items() for r in rs)


@pytest.mark.parametrize('causal', CAUSAL)
@pytest.mark.parametrize('world', WORLDS)
def test_ring_matches_jax_ring(rings, world, causal):
    ref, ref_grads = rings['jax_ring'][world, causal]
    for rank, rec in enumerate(rings['ranks'][world]):
        cols = _blocks(world, rank)
        assert _rel(rec[f'attn/{causal}/out'], ref[:, cols]) <= OUT_TOL
        for n, r in zip('qkv', ref_grads):
            assert _rel(rec[f'attn/{causal}/grad/{n}'], r[:, cols],
                        np.max(np.abs(r))) <= GRAD_TOL, (rank, n)


@pytest.mark.parametrize('causal', CAUSAL)
@pytest.mark.parametrize('world', WORLDS)
def test_ring_matches_local_attention(rings, world, causal):
    ref, ref_grads = rings['local'][causal]
    for rank, rec in enumerate(rings['ranks'][world]):
        cols = _blocks(world, rank)
        assert _rel(rec[f'attn/{causal}/out'], ref[:, cols]) <= OUT_TOL
        for n, r in zip('qkv', ref_grads):
            assert _rel(rec[f'attn/{causal}/grad/{n}'], r[:, cols],
                        np.max(np.abs(r))) <= GRAD_TOL, (rank, n)


@pytest.mark.parametrize('world', WORLDS)
def test_transformer_ring_matches_unsharded_jax(rings, world):
    ref_logits, ref_grads = rings['lm']
    recs = rings['ranks'][world]
    for rank, rec in enumerate(recs):
        assert _rel(rec['lm/logits'], ref_logits[:, _blocks(world, rank)],
                    np.max(np.abs(ref_logits))) <= OUT_TOL, rank
    for name, ref in ref_grads.items():
        assert _rel(recs[0][f'lm/grad/{name}'], ref,
                    _grad_scale(name, ref_grads)) <= GRAD_TOL, name
        for rec in recs[1:]:
            np.testing.assert_array_equal(rec[f'lm/grad/{name}'],
                                          recs[0][f'lm/grad/{name}'])
