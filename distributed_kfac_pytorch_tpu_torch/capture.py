"""Layer registration and activation / output-gradient capture (PyTorch
port of ``distributed_kfac_pytorch_tpu/capture.py``).

Registration walks ``model.named_modules()`` once: every ``nn.Linear`` and
every ``nn.Conv2d`` with ``groups=1`` becomes a :class:`LayerSpec`;
anything else that holds parameters is recorded in
:attr:`KFACCapture.skipped_modules` with its reason, except a trainable
``nn.Embedding`` outside ``skip_layers``: the JAX package preconditions
embeddings, the port does not yet, so it raises.

Capture uses forward hooks: while recording, each registered module's
input is kept (``a``) and a tensor hook on its output keeps the gradient
of the loss with respect to that output (``g``) -- the gradient of the
loss as the caller defines it (a batch mean for the training CLI), the
same scaling as the JAX package's probes. A module called several times
in one pass gets one ``(a, g)`` pair per call.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Sequence

import torch
from torch import nn

LINEAR = 'linear'
CONV2D = 'conv2d'


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Static description of one registered layer (mirrors the JAX
    ``LayerSpec``): what the factor math needs to read its captures and
    map its gradient to and from the 2-D ``(out_dim, in_dim[+1])`` form."""
    path: tuple[str, ...]           # module path (``named_modules`` name)
    kind: str                       # LINEAR | CONV2D
    has_bias: bool
    # conv2d only:
    kernel_size: tuple[int, ...] | None = None
    strides: tuple[int, ...] | None = None
    padding: Any = None

    @property
    def name(self) -> str:
        return '.'.join(self.path)


def _decline_reason(mod: nn.Module) -> str | None:
    """Why a Linear/Conv2d-family module is NOT preconditioned, or None."""
    for base in (nn.Linear, nn.Conv2d):
        if isinstance(mod, base) and type(mod) is not base:
            return (f'{base.__name__} subclass {type(mod).__name__} '
                    f'(capture only matches exact {base.__name__}; its '
                    'call semantics may differ from the factor math)')
    if isinstance(mod, nn.Conv2d):
        if mod.groups != 1:
            return (f'grouped conv (groups={mod.groups}) is not ported '
                    'yet')
        if any(d != 1 for d in mod.dilation):
            return f'dilated conv (dilation={mod.dilation})'
        if mod.padding_mode != 'zeros':
            return f'padding_mode={mod.padding_mode!r}'
    return None


def _spec_for_module(mod: nn.Module, path: tuple[str, ...]
                     ) -> LayerSpec | None:
    if isinstance(mod, nn.Linear):
        return LayerSpec(path=path, kind=LINEAR,
                         has_bias=mod.bias is not None)
    if isinstance(mod, nn.Conv2d):
        padding = mod.padding
        if not isinstance(padding, str):
            padding = ((padding[0], padding[0]), (padding[1], padding[1]))
        return LayerSpec(path=path, kind=CONV2D,
                         has_bias=mod.bias is not None,
                         kernel_size=tuple(mod.kernel_size),
                         strides=tuple(mod.stride), padding=padding)
    return None


class KFACCapture:
    """Registers the supported modules of a model and captures (a, g).

    ``skip_layers``: module names or class names (case-insensitive) whose
    subtrees are left out; frozen modules (no parameter requiring grad)
    are left out too. The hooks stay installed for the life of the
    object and record only inside :meth:`recording`.
    """

    def __init__(self, model: nn.Module,
                 skip_layers: str | Sequence[str] | None = None):
        self.model = model
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
        self._handles = []
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
            own = list(mod.parameters(recurse=False))
            if isinstance(mod, nn.Embedding) and any(p.requires_grad
                                                     for p in own):
                raise NotImplementedError(
                    f'embedding-layer K-FAC is not ported yet: nn.Embedding '
                    f'{name!r} would be preconditioned by the JAX package; '
                    'leave it out with skip_layers')
            if not isinstance(mod, (nn.Linear, nn.Conv2d)):
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
            self._handles.append(mod.register_forward_hook(
                self._make_hook(name)))

    def _make_hook(self, name: str):
        def hook(mod, inputs, output):
            if not self._recording or not torch.is_grad_enabled():
                return
            calls_a = self._a.setdefault(name, [])
            calls_g = self._g.setdefault(name, [])
            idx = len(calls_a)
            calls_a.append(inputs[0].detach())
            calls_g.append(None)
            if output.requires_grad:
                def store(grad, idx=idx):
                    calls_g[idx] = grad.detach()
                output.register_hook(store)
        return hook

    @property
    def specs(self) -> dict[str, LayerSpec]:
        return dict(self._specs)

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
            if any(g is None for g in g_calls):
                raise ValueError(
                    f'layer {name}: an output gradient was never produced '
                    '(was backward run inside recording()?)')
            out[name] = {'a': tuple(a_calls), 'g': tuple(g_calls)}
        self._a, self._g = {}, {}
        return out

    def loss_and_grads(self, loss_fn: Callable, *args,
                       intercept: bool = True, **kwargs):
        """One forward/backward pass: ``(loss, out, grads, captures)``.

        ``loss_fn`` maps the model output (a tensor, or nested tuples and
        lists of tensors such as an LM's ``(logits, states)``) to a scalar
        loss; ``out`` comes back detached. ``grads`` maps
        parameter names to their gradients; ``captures`` is :meth:`collect`
        (``{}`` with ``intercept=False`` -- the non-factor steps, where the
        JAX package skips its capture machinery too).
        """
        self.model.zero_grad(set_to_none=True)
        with self.recording(intercept):
            out = self.model(*args, **kwargs)
            loss = loss_fn(out)
            loss.backward()
        grads = {n: p.grad for n, p in self.model.named_parameters()
                 if p.grad is not None}
        captures = self.collect() if intercept else {}
        return loss.detach(), _detach(out), grads, captures

    def close(self) -> None:
        """Remove the forward hooks."""
        for h in self._handles:
            h.remove()
        self._handles = []


def _detach(out):
    """``out`` with every tensor detached, nested tuples and lists kept."""
    if isinstance(out, torch.Tensor):
        return out.detach()
    if isinstance(out, (tuple, list)):
        return type(out)(_detach(x) for x in out)
    return out
