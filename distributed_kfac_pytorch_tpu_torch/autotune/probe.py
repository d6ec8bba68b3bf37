"""Short warm probe segments per candidate config (PyTorch port of
``distributed_kfac_pytorch_tpu/autotune/probe.py``).

A probe builds the candidate's whole optimizer stack the way the CLIs do
(``OptimConfig -> get_optimizer -> engine.make_train_state``: the
single-device ``KFAC`` in a process alone, ``DistributedKFAC`` under a
process group), runs unrecorded warm cadence windows, then one recorded
segment through ``engine.train_epoch`` (``engine.lm_train_epoch`` for the
LM workload) with the JSONL sink: the candidate is scored on the
telemetry the gate consumes (``observability.gate.gate_metrics`` over the
recorded stream).

  - A candidate the runtime refuses to construct (``inv_pipeline_chunks``
    not dividing the inverse cadence, say) is marked ``invalid:
    <reason>``.
  - The warm windows (two at least) take every kernel's first-use build
    and the allocator's growth; ``fired='compile'`` step records are
    excluded from the score all the same.
  - The recorded steps synchronize the device before and after each step
    (``engine.Observers.sync_steps``), so each step's wall lands in its
    own record: on the card a firing's device time would otherwise spread
    over the next steps' dispatch and flatten the p95 / p99 the weighted
    objective scores.
  - ``peak_hbm_bytes`` is the candidate's own: the previous candidate's
    model, optimizer and K-FAC state are released and the allocator's
    peak counters reset before the build.
  - ``retraces`` stays 0 (the port has no program variants); the field is
    kept in every row so artifacts read across both packages.

Probe workloads are small stand-ins for the real ones (``flagship_lm``
probes a tiny decoder LM, ``cifar_resnet20`` ResNet-20 at full width at
batch 16): the relative ordering of candidates is what a probe measures,
and the artifact records the probe platform and world so the fail-closed
loader refuses to apply it elsewhere.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import tempfile
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Workload:
    """A probe-sized workload: model and synthetic batch factories.

    ``make_model()`` builds the model on the CPU (the probe seeds torch
    first and moves it to the probe's device); ``make_batch(i)`` gives
    batch ``i`` as numpy ``(inputs, labels)``. ``lm``: token windows
    through ``engine.lm_train_epoch`` (the LM step and loss), else images
    through ``engine.train_epoch`` (cross entropy). ``weight_shared``:
    whether the model has layers the ``kfac_approx`` knob acts on;
    ``max_factor_dim``: the largest dense factor dim (0: unknown), so the
    driver drops knobs that cannot change the program."""
    name: str
    make_model: Callable[[], torch.nn.Module]
    make_batch: Callable[[int], tuple]
    batch_size: int
    lm: bool = False
    weight_shared: bool = False
    max_factor_dim: int = 0


def _make_flagship_lm() -> Workload:
    from distributed_kfac_pytorch_tpu_torch.models import transformer_lm
    vocab, seq, batch = 64, 16, 8

    def make_model():
        return transformer_lm.get_model(
            vocab_size=vocab, size='tiny', d_model=32, num_heads=2,
            num_layers=2, max_len=seq, dropout=0.0)

    def make_batch(i):
        rng = np.random.default_rng(1000 + i)
        ids = rng.integers(0, vocab, size=(batch, seq)).astype(np.int64)
        tgt = rng.integers(0, vocab, size=(batch, seq)).astype(np.int64)
        return ids, tgt

    return Workload(name='flagship_lm', make_model=make_model,
                    make_batch=make_batch, batch_size=batch, lm=True,
                    weight_shared=True,
                    # tiny d32: MLP 128 / 129 are the largest dims.
                    max_factor_dim=129)


def _make_cifar_resnet20() -> Workload:
    from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
    batch = 16

    def make_batch(i):
        # The JAX workload's NHWC draw, as NCHW.
        rng = np.random.default_rng(2000 + i)
        x = rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, size=(batch,)).astype(np.int64)
        return np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y

    return Workload(name='cifar_resnet20',
                    make_model=lambda: cifar_resnet.get_model('resnet20'),
                    make_batch=make_batch, batch_size=batch,
                    # resnet20: 3x3x64 = 576 is the largest dim (the
                    # JAX figure, 577, counts a bias column).
                    max_factor_dim=577)


class TinyMLP(torch.nn.Module):
    """The fast-tier stand-in: two Linears and a tanh."""

    def __init__(self):
        super().__init__()
        self.d0 = torch.nn.Linear(8, 16)
        self.head = torch.nn.Linear(16, 8)

    def forward(self, x):
        return self.head(torch.tanh(self.d0(x)))


def _make_tiny_mlp() -> Workload:
    batch = 16

    def make_batch(i):
        rng = np.random.default_rng(3000 + i)
        x = rng.standard_normal((batch, 8)).astype(np.float32)
        y = rng.integers(0, 8, size=(batch,)).astype(np.int64)
        return x, y

    return Workload(name='tiny_mlp', make_model=TinyMLP,
                    make_batch=make_batch, batch_size=batch,
                    # d0 A-side 8+1, G 16; head A 17, G 8: max is 17.
                    max_factor_dim=17)


WORKLOADS: dict[str, Callable[[], Workload]] = {
    'flagship_lm': _make_flagship_lm,
    'cifar_resnet20': _make_cifar_resnet20,
    'tiny_mlp': _make_tiny_mlp,
}


def get_workload(name: str) -> Workload:
    if name not in WORKLOADS:
        raise ValueError(f'unknown workload {name!r} '
                         f'(one of {sorted(WORKLOADS)})')
    return WORKLOADS[name]()


@dataclasses.dataclass
class ProbeResult:
    """One candidate's probe outcome (the scorer's input). ``topology``:
    the probe's world (``elastic.TopologySpec.scalars()``; None when the
    candidate was not built); not part of the row."""
    knobs: dict
    metrics: dict = dataclasses.field(default_factory=dict)
    disqualified: str | None = None
    n_steps: int = 0
    retraces: int = 0
    nonfinite_skips: float = 0.0
    stream_path: str | None = None
    topology: dict | None = None

    def to_row(self) -> dict:
        return {'knobs': dict(self.knobs),
                'metrics': dict(self.metrics),
                'disqualified': self.disqualified,
                'n_steps': self.n_steps,
                'retraces': self.retraces,
                'nonfinite_skips': self.nonfinite_skips}


def _release_device(device) -> None:
    """Free what earlier probes left (cycles included) and reset the
    allocator's peak counters, so a probe's peak is its own."""
    device = torch.device(device)
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _run_epoch(workload: Workload, state, batches: list, hyper: dict,
               device, sink, observers) -> None:
    from distributed_kfac_pytorch_tpu_torch.training import engine
    if workload.lm:
        engine.lm_train_epoch(state, batches, hyper, device=device,
                              metrics_sink=sink, observers=observers)
    else:
        engine.train_epoch(state, batches, hyper, device=device,
                           metrics_sink=sink, observers=observers)


def probe_candidate(workload: Workload, base_cfg, knobs: dict, *,
                    steps: int = 8, warmup_windows: int = 2, seed: int = 0,
                    keep_stream: str | None = None,
                    device='cuda') -> ProbeResult:
    """Run one candidate's warm probe segment and reduce it to metrics.

    ``base_cfg`` is an ``OptimConfig``; ``knobs`` overlays
    ``TUNABLE_FIELDS`` onto it. The probe always enables the on-device
    metrics and the non-finite guard: a candidate that trips the guard is
    data the scorer's hard constraints need. ``keep_stream`` persists the
    recorded JSONL at that path (the committed artifact's evidence);
    otherwise it lives in a temporary directory. Under a process group
    every rank must probe the same candidate at once (the steps are
    collective); each rank scores its own stream.
    """
    from distributed_kfac_pytorch_tpu_torch import elastic, resolve_device
    from distributed_kfac_pytorch_tpu_torch.autotune import driver
    from distributed_kfac_pytorch_tpu_torch.observability import \
        gate as obs_gate
    from distributed_kfac_pytorch_tpu_torch.observability import \
        sink as obs_sink
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.training import engine, \
        optimizers

    device = resolve_device(device)
    result = ProbeResult(knobs=dict(knobs))
    unknown = set(knobs) - set(optimizers.TUNABLE_FIELDS)
    if unknown:
        result.disqualified = f'invalid: unknown knob(s) ' \
                              f'{sorted(unknown)}'
        return result
    cfg = dataclasses.replace(base_cfg, kfac_metrics=True,
                              nonfinite_guard=True, **knobs)
    _release_device(device)
    try:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = workload.make_model()
        model = model.to(device)
        optimizer, _, kfac, _ = optimizers.get_optimizer(model, cfg,
                                                         device=device)
        if kfac is None:
            raise ValueError('candidate disables K-FAC '
                             '(kfac_inv_update_freq == 0)')
        state = engine.make_train_state(model, optimizer, kfac)
    except (ValueError, TypeError) as e:
        result.disqualified = f'invalid: {e}'
        return result
    result.topology = elastic.TopologySpec.of_world(state.kfac).scalars()

    f_freq = int(cfg.kfac_cov_update_freq)
    i_freq = int(cfg.kfac_inv_update_freq)
    hyper = {'lr': cfg.base_lr, 'damping': cfg.damping,
             'factor_update_freq': f_freq, 'inv_update_freq': i_freq}
    pool = [workload.make_batch(i) for i in range(4)]
    n_warm = max(2, int(warmup_windows)) * i_freq
    # Warm windows: every kernel's first-use build, the allocator's growth
    # and each stage the cadence fires happen here, outside the recorded
    # segment. Two windows at least: the second runs on state the first
    # firing produced, as the recorded segment does.
    _run_epoch(workload, state, [pool[i % 4] for i in range(n_warm)],
               hyper, device, None, None)
    kernels.drain_build_events()     # warm-up builds are expected

    tmp = None
    if keep_stream is None:
        tmp = tempfile.mkdtemp(prefix='kfac_autotune_')
        stream = os.path.join(tmp, 'probe.jsonl')
    else:
        stream = keep_stream
    sink = obs_sink.JsonlMetricsSink(
        stream, meta={'autotune_probe': workload.name,
                      'knobs': {k: repr(v) for k, v in knobs.items()},
                      'backend': driver.platform_of(device)})
    observers = engine.Observers(memory_interval=max(1, i_freq),
                                 sync_steps=True)
    _run_epoch(workload, state, [pool[i % 4] for i in range(int(steps))],
               hyper, device, sink, observers)
    sink.close()

    records, _ = obs_sink.read_jsonl_tolerant(stream)
    # Compile-labelled samples carry a kernel build, not step time.
    scored = [r for r in records
              if not (r.get('kind') == 'step'
                      and r.get('fired') == 'compile')]
    result.metrics = obs_gate.gate_metrics(scored)
    result.n_steps = result.metrics.get('n_steps', 0)
    result.retraces = sum(
        1 for r in records
        if r.get('kind') == 'event' and r.get('event') == 'retrace')
    step_records = [r for r in records if r.get('kind') == 'step']
    if step_records:
        result.nonfinite_skips = float(obs_sink.to_float(
            step_records[-1].get('metrics', {}).get(
                'kfac/nonfinite_skips', 0.0)))
        if not np.isfinite(result.nonfinite_skips):
            result.nonfinite_skips = float('inf')
    if result.retraces:
        result.disqualified = 'retraces: a static-cadence variant ' \
                              'recompiled mid-probe'
    if keep_stream is not None:
        result.stream_path = stream
    elif tmp is not None:
        # Temporary streams are evidence only while the probe runs.
        for name in os.listdir(tmp):
            os.unlink(os.path.join(tmp, name))
        os.rmdir(tmp)
    return result
