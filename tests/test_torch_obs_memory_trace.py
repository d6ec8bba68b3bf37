"""The port's memory telemetry, trace table and profiler scopes on the CPU,
against the JAX package:

  - ``memory.state_footprint`` equals JAX's on the same K-FAC state (the
    JAX ``KFAC.init`` state's layout, carried across by ``convert.
    jax_state_to_torch``), group by group and dtype by dtype, for fp32,
    bf16 storage, the metrics and the overlap knobs' state; the port
    keeps ``step`` and ``inv_chunk_phase`` as Python ints, JAX as int32
    arrays (its 8 bytes of 'other');
  - ``memory.device_memory_stats`` is ``{}`` off CUDA, and
    ``format_bytes`` is JAX's;
  - the trace table (``observability.tracing`` and its ``utils``
    re-exports) has the JAX module's semantics on the same fake clock;
  - the profiler scopes: a K-FAC step under ``torch.profiler`` carries
    the ``kfac/*`` scope names, and the step with the scopes equals the
    step without them bit for bit, with the same recorded ops;
  - ``--profile-dir`` writes a Chrome trace on rank 0 only, once.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu import utils as jutils
from distributed_kfac_pytorch_tpu.models import cifar_resnet as jres
from distributed_kfac_pytorch_tpu.observability import memory as jmemory
from distributed_kfac_pytorch_tpu.observability import tracing as jtracing
from distributed_kfac_pytorch_tpu_torch import convert, utils
from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
from distributed_kfac_pytorch_tpu_torch.observability import cli as obs_cli
from distributed_kfac_pytorch_tpu_torch.observability import memory, \
    profiling, tracing
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


B, PX = 4, 8
COMMON = dict(damping=0.003, lr=0.1, kl_clip=0.001, factor_update_freq=1,
              inv_update_freq=2)

# (JAX knobs, port knobs) of each state layout.
LAYOUTS = {
    'fp32': ({}, {}),
    'bf16': ({'factor_dtype': jnp.bfloat16, 'inv_dtype': jnp.bfloat16},
             {'factor_dtype': torch.bfloat16,
              'inv_dtype': torch.bfloat16}),
    'metrics': ({'collect_metrics': True}, {'collect_metrics': True}),
    'overlap': ({'deferred_factor_reduction': True, 'inv_staleness': 1},
                {'deferred_factor_reduction': True, 'inv_staleness': 1}),
}


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_state_footprint_matches_jax(layout):
    jknobs, knobs = LAYOUTS[layout]
    x = np.random.default_rng(0).normal(size=(B, PX, PX, 3)).astype(
        'float32')
    jkfac = JKFAC(jres.CifarResNet(num_blocks=(1, 1, 1)), **COMMON,
                  **jknobs)
    # Shapes and dtypes are all the footprint reads: trace the init and
    # stand numpy zeros in for its arrays.
    _, shapes = jax.eval_shape(jkfac.init, jax.random.PRNGKey(0),
                               jnp.asarray(x))
    jstate = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    want = jmemory.state_footprint(jstate)
    kfac = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu',
                **COMMON, **knobs)
    state = convert.jax_state_to_torch(
        {k: v for k, v in jstate.items() if k != 'metrics'}, kfac.specs)
    fresh = kfac.init_state()
    if 'metrics' in fresh:
        state['metrics'] = fresh['metrics']
    got = memory.state_footprint(state)
    # Every group and group/dtype but 'other' exactly (JAX's int32 step
    # and chunk phase are Python ints in the port).
    assert got['by_group'].pop('other', 0) + 8 == \
        want['by_group'].pop('other')
    assert got['by_group'] == want['by_group']
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if not k.startswith('other/')}
    assert strip(got['by_group_dtype']) == strip(want['by_group_dtype'])
    assert got['total_bytes'] == want['total_bytes'] - 8
    # The port's own fresh state has the same layout.
    assert memory.state_footprint(fresh)['by_group_dtype'] == \
        got['by_group_dtype']
    assert utils.tree_bytes(state) == got['total_bytes']


def test_device_stats_off_cuda_and_format_bytes():
    assert memory.device_memory_stats() == {} or torch.cuda.is_available()
    assert memory.device_memory_stats('cpu') == {}
    assert memory.device_memory_stats(torch.device('cpu')) == {}
    for n in (0, 1023, 1024, 3 << 29, 5e12, 7e15, 'x'):
        assert memory.format_bytes(n) == jmemory.format_bytes(n)
    assert memory.state_footprint(None) == jmemory.state_footprint(None)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


@pytest.mark.parametrize('average,history', [(True, None), (False, None),
                                             (True, 2), (False, 1)])
def test_trace_table_semantics_match_jax(monkeypatch, average, history):
    tables = []
    for mod, trace_fn in ((tracing, utils.trace), (jtracing, jutils.trace)):
        monkeypatch.setattr(mod.time, 'perf_counter', _Clock())
        mod.clear_trace()

        @trace_fn(name='stage')
        def stage(v):
            return v

        @trace_fn()
        def other():
            return None

        for v in range(3):
            stage(v)
        other()
        mod.record('train_step_dispatch', 0.5)
        mod.record('train_step_dispatch', 1.5)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.print_trace(average, history)
        tables.append((mod.get_trace(average, history),
                       mod.snapshot_trace(), buf.getvalue()))
        mod.clear_trace()
        assert mod.get_trace() == {} and mod.snapshot_trace() == {}
    assert tables[0] == tables[1]
    assert tables[0][1]['stage']['count'] == 3
    assert utils.get_trace is tracing.get_trace
    assert utils._FUNC_TRACES is tracing._FUNC_TRACES


def test_trace_sync_passes_through_on_cpu():
    tracing.clear_trace()

    @tracing.trace(sync=True, name='sync_stage')
    def f(x, scale=2.0):
        return {'y': x * scale, 'n': [x]}

    out = f(torch.ones(3), scale=3.0)
    assert torch.equal(out['y'], torch.full((3,), 3.0))
    assert tracing.snapshot_trace()['sync_stage']['count'] == 1
    tracing.clear_trace()


def _step_inputs():
    torch.manual_seed(0)
    model = cifar_resnet.CifarResNet((1, 1, 1))
    kfac = KFAC(model, device='cpu', **COMMON, collect_metrics=True,
                eigh_method='xla')
    x = torch.randn(B, 3, PX, PX)
    y = torch.randint(0, 10, (B,))
    loss, _, grads, captures = kfac.capture.loss_and_grads(
        lambda out: F.cross_entropy(out, y), x)
    return kfac, grads, captures


class _Null:
    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _profiled_step(kfac, grads, captures):
    from torch.profiler import ProfilerActivity, profile
    state = kfac.init_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        precond, state = kfac.step(state, grads, captures,
                                   factor_update=True, inv_update=True)
    names = [e.name for e in prof.events()]
    return precond, state, names


def test_scopes_change_no_number_and_no_op(monkeypatch):
    kfac, grads, captures = _step_inputs()
    kfac.step(kfac.init_state(), grads, captures, factor_update=True,
              inv_update=True)                  # warm the KFAC's caches
    precond, state, names = _profiled_step(kfac, grads, captures)
    scopes = {n for n in names if n.startswith('kfac/')}
    assert {'kfac/factors', 'kfac/inverses', 'kfac/precond',
            'kfac/factors/conv2d_a', 'kfac/factors/conv2d_g',
            'kfac/factors/linear_a', 'kfac/factors/linear_g',
            'kfac/eigh/xla', 'kfac/precond/eigen'} <= scopes, scopes
    monkeypatch.setattr(profiling, 'annotate', _Null)
    precond0, state0, names0 = _profiled_step(kfac, grads, captures)
    assert not [n for n in names0 if n.startswith('kfac/')]
    for k in precond:
        assert torch.equal(precond[k], precond0[k]), k
    for name in state['factors']:
        for side in 'AG':
            assert torch.equal(state['factors'][name][side],
                               state0['factors'][name][side])
    ops = [n for n in names if not n.startswith('kfac/')]
    assert ops == names0


def test_scope_names_of_each_branch():
    from distributed_kfac_pytorch_tpu_torch.preconditioner import \
        factor_scope, precond_scope
    kfac = KFAC(cifar_resnet.CifarResNet((1, 1, 1)), device='cpu')
    spec = kfac.specs['conv1']
    assert factor_scope(spec, 'A') == 'kfac/factors/conv2d_a'
    assert factor_scope(kfac.specs['linear'], 'G') == 'kfac/factors/linear_g'
    assert precond_scope({'QA': 0}) == 'kfac/precond/eigen'
    assert precond_scope({'A_inv': 0}) == 'kfac/precond/inv'


def test_profile_dir_rank0_only_and_once(tmp_path):
    d0, d1 = str(tmp_path / 'r0'), str(tmp_path / 'r1')
    with obs_cli.profile_epoch(d1, 1):
        torch.ones(3).sum()
    assert not os.path.exists(d1)
    with obs_cli.profile_epoch(d0, 0):
        # Idempotent: a nested start does nothing.
        assert profiling.start_trace(d0) is False
        with profiling.annotate('kfac/probe'):
            torch.ones(3).sum()
    assert profiling.stop_trace() is None
    files = profiling.trace_files(d0)
    assert len(files) == 1
    trace = json.load(open(files[0]))
    assert any(ev.get('name') == 'kfac/probe'
               for ev in trace['traceEvents'])
    with obs_cli.profile_epoch(None, 0):
        pass
    assert len(profiling.trace_files(d0)) == 1
