"""Layer registration and activation / output-gradient capture (PyTorch
port of ``distributed_kfac_pytorch_tpu/capture.py``).

Registration walks ``model.named_modules()`` once: every ``nn.Linear``,
every ``nn.Conv2d`` (kind ``conv2d``, or ``conv2d_grouped`` with its
``feature_group_count`` when ``groups > 1``: per-group block-diagonal
factors, the depthwise convs of MobileNet) and every ``nn.Embedding``
(or the port's
:class:`~distributed_kfac_pytorch_tpu_torch.modules.embed.Embed`)
becomes a :class:`LayerSpec`; anything else that holds parameters is
recorded in :attr:`KFACCapture.skipped_modules` with its reason, as is
every module a ``trainable`` predicate marks frozen.

Capture uses forward hooks: while recording, each registered module's
input is kept (``a``; an embedding's ids) and a tensor hook on its output
keeps the gradient of the loss with respect to that output (``g``) -- the
gradient of the loss as the caller defines it (a batch mean for the
training CLI), the same scaling as the JAX package's probes. A module
called several times in one pass gets one ``(a, g)`` pair per call. The
input is read by a forward pre-hook that runs before every other one:
``a`` is the input as the model passes it, before a compute-dtype cast
(``modules.precision``), as the JAX package sows a module's input before
flax casts it -- a half-precision model's stem keeps its fp32 image.

Tied embeddings (``tied_embeddings=True``): torch has no method
interceptor, so the tied in/out use must be visible as a call. An
``Embed``'s ``attend(x)`` (the logits ``x E^T``, flax's ``Embed.attend``)
is wrapped while the capture is open; each recorded call adds ``x`` to
the layer's ``a_tied`` stream and the logits' gradient to ``g_tied``,
paired by index. The weight's gradient stays the sum over both uses. A
bare ``x @ embed.weight.T`` is invisible to capture.

A rematerialized block (``torch.utils.checkpoint`` with
:func:`recomputation` as its recompute context) is captured in the
forward pass only: its recomputation in the backward pass fires the
forward hooks again, and they record nothing while it runs, so each layer
is captured once per pass, as under the JAX package's ``nn.remat``.

``capture_dtype`` (the JAX knob) casts the kept activations: ``None``
and ``'auto'`` keep them as they are (the JAX package casts under
``'auto'`` on a TPU only), an explicit dtype casts every floating ``a``
and ``a_tied`` to it. Output-gradients are never cast.

The weight-sharing approximation of each layer (``LayerSpec.kfac_approx``)
is resolved by ``sharing.approx``; a Linear's shared-axis positions
(``shared_positions``) are read from its input at the first recorded
call (:meth:`KFACCapture.observed_specs`), since registration runs no
forward pass.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Sequence

import torch
from torch import nn

from distributed_kfac_pytorch_tpu_torch.modules.embed import Embed

LINEAR = 'linear'
CONV2D = 'conv2d'
# Grouped / depthwise conv: one (A, G) factor pair per group, stacked
# (G, d, d) (the JAX package's conv2d_grouped).
CONV2D_GROUPED = 'conv2d_grouped'
EMBEDDING = 'embedding'
# Weight-sharing Kronecker approximations (arXiv:2311.00636):
# KFAC_EXPAND flattens a shared (sequence / patch) axis into covariance
# rows; KFAC_REDUCE averages activations and sums output-grads over it
# before the covariance. Resolved per layer by sharing.approx.
KFAC_EXPAND = 'expand'
KFAC_REDUCE = 'reduce'
KFAC_APPROXES = (KFAC_EXPAND, KFAC_REDUCE)

# Depth of :func:`recomputation` contexts on this thread (the autograd
# thread that recomputes a checkpointed block).
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputation():
    """The recomputation of a rematerialized block in the backward pass
    (``torch.utils.checkpoint``'s recompute context): no capture records
    inside, so the layers the block's forward pass captured are not
    captured a second time."""
    depth = getattr(_RECOMPUTE, 'depth', 0)
    _RECOMPUTE.depth = depth + 1
    try:
        yield
    finally:
        _RECOMPUTE.depth = depth


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Static description of one registered layer (mirrors the JAX
    ``LayerSpec``): what the factor math needs to read its captures and
    map its gradient to and from the 2-D ``(out_dim, in_dim[+1])`` form
    (``(vocab, dim)`` for an embedding)."""
    path: tuple[str, ...]           # module path (``named_modules`` name)
    kind: str                # LINEAR | CONV2D | CONV2D_GROUPED | EMBEDDING
    has_bias: bool
    # conv2d / conv2d_grouped only:
    kernel_size: tuple[int, ...] | None = None
    strides: tuple[int, ...] | None = None
    padding: Any = None
    feature_group_count: int = 1   # conv2d_grouped: number of groups
    # embedding only:
    vocab_size: int | None = None
    # KFAC_EXPAND | KFAC_REDUCE (sharing.approx.annotate_specs).
    kfac_approx: str = KFAC_EXPAND
    # A Linear's shared-axis positions: the product of its input's dims
    # between batch and features (1 for a 2-D input).
    shared_positions: int = 1
    # Tied attend call sites captured for this embedding (0: lookup only).
    tied_calls: int = 0

    @property
    def name(self) -> str:
        return '.'.join(self.path)


def _decline_reason(mod: nn.Module) -> str | None:
    """Why a Linear/Conv2d/Embedding-family module is NOT preconditioned,
    or None."""
    for base in (nn.Linear, nn.Conv2d, nn.Embedding):
        if isinstance(mod, base) and type(mod) not in (base, Embed):
            return (f'{base.__name__} subclass {type(mod).__name__} '
                    f'(capture only matches exact {base.__name__}; its '
                    'call semantics may differ from the factor math)')
    if isinstance(mod, nn.Embedding):
        for attr, off in (('padding_idx', None), ('max_norm', None),
                          ('scale_grad_by_freq', False), ('sparse', False)):
            if getattr(mod, attr) != off:
                return (f'embedding with {attr}={getattr(mod, attr)!r} '
                        '(not modelled by the factor math)')
    if isinstance(mod, nn.Conv2d):
        if any(d != 1 for d in mod.dilation):
            return f'dilated conv (dilation={mod.dilation})'
        if mod.padding_mode != 'zeros':
            return f'padding_mode={mod.padding_mode!r}'
    return None


def _spec_for_module(mod: nn.Module, path: tuple[str, ...]
                     ) -> LayerSpec | None:
    if isinstance(mod, nn.Embedding):
        return LayerSpec(path=path, kind=EMBEDDING, has_bias=False,
                         vocab_size=mod.num_embeddings)
    if isinstance(mod, nn.Linear):
        return LayerSpec(path=path, kind=LINEAR,
                         has_bias=mod.bias is not None)
    if isinstance(mod, nn.Conv2d):
        padding = mod.padding
        if not isinstance(padding, str):
            padding = ((padding[0], padding[0]), (padding[1], padding[1]))
        return LayerSpec(path=path,
                         kind=CONV2D if mod.groups == 1 else CONV2D_GROUPED,
                         has_bias=mod.bias is not None,
                         kernel_size=tuple(mod.kernel_size),
                         strides=tuple(mod.stride), padding=padding,
                         feature_group_count=mod.groups)
    return None


class KFACCapture:
    """Registers the supported modules of a model and captures (a, g).

    ``skip_layers``: module names or class names (case-insensitive) whose
    subtrees are left out; frozen modules (no parameter requiring grad)
    are left out too, and so is every module for which ``trainable(name)``
    is false (the JAX predicate, given the module's ``named_modules`` name,
    ``a.b``, where JAX joins its path as ``a/b``): its parameters get plain
    gradients and no factor work. ``tied_embeddings``: also capture the ``attend``
    calls of registered ``Embed`` modules (the tied decoder).
    ``capture_dtype``: ``'auto'`` or None keep captured activations as
    they are, a dtype casts floating ones to it (never the output-grads).
    The hooks stay installed for the life of the object (until
    :meth:`close`) and record only inside :meth:`recording`.
    """

    def __init__(self, model: nn.Module,
                 skip_layers: str | Sequence[str] | None = None,
                 tied_embeddings: bool = False,
                 capture_dtype: Any = 'auto',
                 trainable: Callable[[str], bool] | None = None):
        self.model = model
        self.trainable = trainable
        self.tied_embeddings = bool(tied_embeddings)
        self.capture_dtype = capture_dtype
        if skip_layers is None:
            skip_layers = []
        elif isinstance(skip_layers, str):
            skip_layers = [skip_layers]
        self.skip_layers = frozenset(s.lower() for s in skip_layers)
        self._specs: dict[str, LayerSpec] = {}
        self._skipped: dict[str, str] = {}
        self._recording = False
        self._a: dict[str, list] = {}
        self._g: dict[str, list] = {}
        self._a_tied: dict[str, list] = {}
        self._g_tied: dict[str, list] = {}
        self._shared: dict[str, int] = {}
        self._tied_seen: dict[str, int] = {}
        self._inputs: dict[str, torch.Tensor] = {}
        self._handles = []
        self._wrapped: list[nn.Module] = []
        self._register()

    def _is_skipped(self, mod: nn.Module, path: tuple[str, ...]) -> bool:
        if type(mod).__name__.lower() in self.skip_layers:
            return True
        return any(part.lower() in self.skip_layers for part in path)

    def _register(self) -> None:
        skipped_prefixes: list[tuple[str, ...]] = []
        for name, mod in self.model.named_modules():
            path = tuple(name.split('.')) if name else ()
            if any(path[:len(p)] == p for p in skipped_prefixes):
                continue
            if self._is_skipped(mod, path):
                skipped_prefixes.append(path)
                if path:
                    self._skipped[name] = 'skip_layers match'
                continue
            if self.trainable is not None and not self.trainable(name):
                if path:
                    self._skipped[name] = ('frozen (trainable predicate): '
                                           'plain gradients, no factor work')
                continue
            own = list(mod.parameters(recurse=False))
            if not isinstance(mod, (nn.Linear, nn.Conv2d, nn.Embedding)):
                if own:
                    self._skipped[name] = (
                        'unsupported module type (params receive plain '
                        'gradients)')
                continue
            if not any(p.requires_grad for p in own):
                self._skipped[name] = ('frozen (no parameter requires '
                                       'grad): plain gradients, no factor '
                                       'work')
                continue
            reason = _decline_reason(mod)
            if reason is not None:
                self._skipped[name] = reason
                continue
            self._specs[name] = _spec_for_module(mod, path)
            self._handles.append(mod.register_forward_pre_hook(
                self._make_pre_hook(name), prepend=True))
            self._handles.append(mod.register_forward_hook(
                self._make_hook(name)))
            if self.tied_embeddings and hasattr(mod, 'attend'):
                mod.attend = self._make_attend(name, mod.attend)
                self._wrapped.append(mod)

    def _record(self, name: str, x: torch.Tensor, y: torch.Tensor,
                a_store: dict, g_store: dict) -> bool:
        """Keep ``x`` and, through a tensor hook on ``y``, the gradient of
        the loss with respect to ``y``, as one call of ``name``; False
        when not :meth:`_capturing`."""
        if not self._capturing():
            return False
        calls_a = a_store.setdefault(name, [])
        calls_g = g_store.setdefault(name, [])
        idx = len(calls_a)
        calls_a.append(self._cast(x.detach()))
        calls_g.append(None)
        if y.requires_grad:
            def store(grad, idx=idx):
                calls_g[idx] = grad.detach()
            y.register_hook(store)
        return True

    def _capturing(self) -> bool:
        """A forward call is captured: recording, grad on, and not inside
        a rematerialized block's recomputation."""
        return (self._recording and torch.is_grad_enabled()
                and not getattr(_RECOMPUTE, 'depth', 0))

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        """A captured activation in ``capture_dtype``: an explicit dtype
        casts a floating ``x``; ``'auto'`` and None pass it through."""
        cd = self.capture_dtype
        if cd is None or cd == 'auto' or not x.is_floating_point():
            return x
        return x.to(cd)

    def _make_pre_hook(self, name: str):
        def pre_hook(mod, inputs):
            # Kept only for a captured call, whose forward hook pops it: a
            # recomputation stopped early skips that hook.
            if self._capturing():
                self._inputs[name] = inputs[0]
        return pre_hook

    def _make_hook(self, name: str):
        def hook(mod, inputs, output):
            x = self._inputs.pop(name, inputs[0])
            if self._record(name, x, output, self._a, self._g) \
                    and name not in self._shared:
                self._shared[name] = math.prod(x.shape[1:-1])
        return hook

    def _make_attend(self, name: str, attend: Callable):
        def wrapped(x):
            y = attend(x)
            self._record(name, x, y, self._a_tied, self._g_tied)
            return y
        return wrapped

    @property
    def specs(self) -> dict[str, LayerSpec]:
        return dict(self._specs)

    def observed_specs(self, specs: dict[str, LayerSpec]
                       ) -> dict[str, LayerSpec]:
        """``specs`` with what the recorded calls showed: each Linear's
        ``shared_positions`` (from its first recorded input) and each
        embedding's ``tied_calls`` (attend calls in the last recorded
        pass)."""
        out = dict(specs)
        for name, spec in specs.items():
            if spec.kind == LINEAR and name in self._shared:
                out[name] = dataclasses.replace(
                    spec, shared_positions=self._shared[name])
            elif spec.kind == EMBEDDING:
                out[name] = dataclasses.replace(
                    spec, tied_calls=self._tied_seen.get(name, 0))
        return out

    @property
    def skipped_modules(self) -> dict[str, str]:
        """{module name: reason} for every parameterized module K-FAC does
        not precondition."""
        return dict(self._skipped)

    @contextlib.contextmanager
    def recording(self, enabled: bool = True):
        """Record captures for the forward/backward passes inside."""
        prev = self._recording
        self._recording = enabled
        try:
            yield
        finally:
            self._recording = prev

    def collect(self) -> dict[str, dict]:
        """``{layer: {'a': (per-call inputs), 'g': (per-call output
        grads)}}`` of the recorded passes; clears the buffers."""
        out = {}
        for name in self._specs:
            a_calls = self._a.get(name, [])
            g_calls = self._g.get(name, [])
            tied = self._g_tied.get(name, [])
            if any(g is None for g in (*g_calls, *tied)):
                raise ValueError(
                    f'layer {name}: an output gradient was never produced '
                    '(was backward run inside recording()?)')
            out[name] = {'a': tuple(a_calls), 'g': tuple(g_calls)}
            if tied:
                out[name]['a_tied'] = tuple(self._a_tied[name])
                out[name]['g_tied'] = tuple(tied)
            self._tied_seen[name] = len(tied)
        self._a, self._g, self._a_tied, self._g_tied = {}, {}, {}, {}
        return out

    def loss_and_grads(self, loss_fn: Callable, *args,
                       intercept: bool = True, loss_scale=None, **kwargs):
        """One forward/backward pass: ``(loss, out, grads, captures)``.

        ``loss_fn`` maps the model output (a tensor, or nested tuples and
        lists of tensors such as an LM's ``(logits, states)``) to a scalar
        loss; ``out`` comes back detached. ``grads`` maps
        parameter names to their gradients; ``captures`` is :meth:`collect`
        (``{}`` with ``intercept=False`` -- the non-factor steps, where the
        JAX package skips its capture machinery too).

        ``loss_scale`` (a float or an fp32 device scalar; the fp16 loss
        scaling of the JAX ``loss_and_grads``) multiplies the loss before
        the backward pass; the loss, the gradients and the output-gradient
        captures (``g``, ``g_tied``) come back divided by it, in fp32 (an
        fp16 output-gradient times an fp32 device scalar would stay fp16
        in torch, where JAX promotes it), on both the intercepting and
        the plain path.
        """
        self.model.zero_grad(set_to_none=True)
        with self.recording(intercept):
            out = self.model(*args, **kwargs)
            loss = loss_fn(out)
            scaled = loss if loss_scale is None else loss.float() * loss_scale
            scaled.backward()
        grads = {n: p.grad for n, p in self.model.named_parameters()
                 if p.grad is not None}
        captures = self.collect() if intercept else {}
        loss = scaled.detach()
        if loss_scale is not None:
            inv = 1.0 / loss_scale
            loss = loss * inv
            grads = {n: g.float() * inv for n, g in grads.items()}
            captures = {name: {k: (tuple(t.float() * inv for t in calls)
                                   if k in ('g', 'g_tied') else calls)
                               for k, calls in entry.items()}
                        for name, entry in captures.items()}
        return loss, _detach(out), grads, captures

    def close(self) -> None:
        """Remove the forward hooks and the ``attend`` wrappers."""
        for h in self._handles:
            h.remove()
        for mod in self._wrapped:
            del mod.attend
        self._handles, self._wrapped = [], []


def subsample_captures(captures: dict, fraction: float) -> dict:
    """Keep ``ceil(B * fraction)`` batch rows of every capture, at the
    evenly spread positions ``arange(k) * B // k`` (strided over the whole
    batch, never a head slice), as the JAX package's
    ``subsample_captures``: the factor statistics of a batch thinned
    within the step. Every stream thins alike, a tied embedding's
    ``a_tied`` / ``g_tied`` included; the gradients are untouched.
    ``fraction >= 1`` returns ``captures`` itself."""
    if fraction >= 1.0:
        return captures

    def keep(t):
        b = t.shape[0]
        k = max(1, int(math.ceil(b * fraction)))
        if k >= b:
            return t
        idx = torch.arange(k, device=t.device) * b // k
        return t.index_select(0, idx)

    return {name: {key: tuple(keep(t) for t in calls)
                   for key, calls in c.items()}
            for name, c in captures.items()}


def _detach(out):
    """``out`` with every tensor detached, nested tuples and lists kept."""
    if isinstance(out, torch.Tensor):
        return out.detach()
    if isinstance(out, (tuple, list)):
        return type(out)(_detach(x) for x in out)
    return out
