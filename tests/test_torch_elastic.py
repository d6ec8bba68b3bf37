"""Elastic resume of the torch port against the JAX package, on the CPU:
the topology record (``TopologySpec`` scalars, layout keys and reshard
decisions), the ``resize`` / ``slice-loss`` fault grammar, the canonical
gather of the row stacks (the same per-factor matrices laid out in each
package's stacks gather to the same canonical form, bit for bit, on grids
2 x 2, 2 x 1 and 1 x 1), the lossless repack round trips 2 x 2 -> 2 x 1 ->
2 x 2 and 2 x 2 -> 1 x 1 -> 2 x 2, the cross-configuration drop and the
accumulator drop against the JAX outcome, the cross-world restore of
``CheckpointManager`` and the chaos harness's relaunch at a new world
size with tiny children.
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn as nn

from distributed_kfac_pytorch_tpu import KFAC as JKFAC
from distributed_kfac_pytorch_tpu.elastic import reshard as jreshard
from distributed_kfac_pytorch_tpu.elastic import topology as jtopo
from distributed_kfac_pytorch_tpu.parallel import distributed as JD
from distributed_kfac_pytorch_tpu.preconditioner import \
    _overlay_overlap_state as j_overlay
from distributed_kfac_pytorch_tpu.resilience import faults as jfaults
from distributed_kfac_pytorch_tpu_torch.elastic import reshard, topology
from distributed_kfac_pytorch_tpu_torch.parallel import distributed as D
from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC, \
    overlay_overlap_state
from distributed_kfac_pytorch_tpu_torch.resilience import cli as resil_cli
from distributed_kfac_pytorch_tpu_torch.resilience import faults
from distributed_kfac_pytorch_tpu_torch.resilience.preemption import \
    RELAUNCH_EXIT_CODE
from distributed_kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from test_elastic import _ElasticNet


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class ElasticNet(nn.Module):
    """Torch twin of the JAX suite's ``_ElasticNet``: five denses with
    repeated and odd widths, so the grids leave padding slots."""

    def __init__(self):
        super().__init__()
        dims = (8, 16, 16, 12, 16, 4)
        for i in range(5):
            setattr(self, f'Dense_{i}', nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(4):
            x = torch.relu(getattr(self, f'Dense_{i}')(x))
        return self.Dense_4(x)


@pytest.fixture(scope='module')
def nets():
    jk = JKFAC(_ElasticNet(), factor_update_freq=1, inv_update_freq=2,
               damping=0.003, lr=0.1)
    variables, _ = jk.init(jax.random.PRNGKey(0), jnp.zeros((2, 8)))
    torch.manual_seed(0)
    kfac = KFAC(ElasticNet(), device='cpu', damping=0.003)
    assert list(jk.specs) == list(kfac.specs)
    return jk, variables['params'], kfac


# ---------------------------------------------------------------------------
# The topology record
# ---------------------------------------------------------------------------

SPECS = [(1, 1, 1, 1, 1, 1, False), (4, 4, 2, 2, 1, 1, True),
         (2, 8, 2, 4, 1, 1, False), (4, 4, 1, 2, 1, 2, True),
         (8, 8, 2, 1, 2, 2, False), (4, 4, 4, 1, 1, 1, False)]


@pytest.mark.parametrize('spec', SPECS, ids=str)
def test_topology_scalars_match_jax(spec):
    got = topology.TopologySpec(*spec)
    want = jtopo.TopologySpec(*spec)
    assert got.scalars() == want.scalars()
    assert topology.TOPOLOGY_FORMAT == jtopo.TOPOLOGY_FORMAT
    assert topology.SCALAR_KEYS == jtopo.SCALAR_KEYS
    assert got.layout_key == want.layout_key
    assert got.describe() == want.describe()
    assert topology.TopologySpec.from_scalars(got.scalars()) == got
    for other in SPECS:
        assert got.needs_reshard(topology.TopologySpec(*other)) == \
            want.needs_reshard(jtopo.TopologySpec(*other))


def test_topology_missing_future_and_inconsistent():
    for mod in (topology, jtopo):
        assert mod.TopologySpec.from_scalars({}) is None
        assert mod.TopologySpec.from_scalars({'step': 3}) is None
        sc = mod.TopologySpec(1, 4, 2, 2).scalars()
        sc['topo_format'] += 1
        assert mod.TopologySpec.from_scalars(sc) is None
        with pytest.raises(ValueError, match='inconsistent topology'):
            mod.TopologySpec(1, 8, 2, 2)
    # Slice-count changes that keep the global rows keep the layout.
    a = topology.TopologySpec(4, 4, 1, 2, slices=2)
    assert not a.needs_reshard(topology.TopologySpec(4, 4, 2, 2))


def test_of_world(monkeypatch, nets):
    assert topology.TopologySpec.of_world() == topology.TopologySpec(
        1, 1, 1, 1, distribute_layer_factors=False)
    assert topology.TopologySpec.of_world(nets[2]).layout_key == (1, 1, False)
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_world_size', lambda group=None: 4)
    view = _rank_view(nets[2], 2, 2, 0)
    t = topology.TopologySpec.of_world(view)
    assert (t.processes, t.devices, t.rows, t.cols, t.seq, t.slices,
            t.distribute_layer_factors) == (4, 4, 2, 2, 1, 1, True)
    assert topology.TopologySpec.of_world() == topology.TopologySpec(
        4, 4, 1, 4, distribute_layer_factors=True)


# ---------------------------------------------------------------------------
# resize / slice-loss grammar, as tests/test_elastic.py pins it for JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('spec', [
    'resize@2->4', 'nan-batch@1,resize@3->2', 'slice-loss@2->1',
    'hang@3', 'slowrank@0', 'hang@1,slowrank@2,resize@4->2'])
def test_parse_spec_accepts_as_jax(spec):
    assert faults.parse_spec(spec).__dict__ == \
        jfaults.parse_spec(spec).__dict__
    faults.check_ported(faults.parse_spec(spec))


@pytest.mark.parametrize('spec', [
    'resize@2', 'resize@->4', 'resize@2->0', 'resize@2->x', 'resize@a->4',
    'preempt@1,resize@3->2', 'slice-loss@2', 'resize@1->2,slice-loss@2->1',
    'hang@x'])
def test_parse_spec_rejects_as_jax(spec):
    with pytest.raises(ValueError) as jerr:
        jfaults.parse_spec(spec)
    with pytest.raises(ValueError) as err:
        faults.parse_spec(spec)
    assert str(err.value) == str(jerr.value)


def test_every_fault_kind_is_ported():
    armed = [f for f in faults.FaultPlan.__dataclass_fields__
             if f.endswith('_at')]
    assert sorted(faults.PORTED) == sorted(armed)
    assert faults.SLOWRANK_DELAY_S == jfaults.SLOWRANK_DELAY_S


def test_slow_step_delays_from_step_k(monkeypatch):
    naps = []
    monkeypatch.setattr('time.sleep', naps.append)
    plan = faults.parse_spec('slowrank@3')
    for step in range(6):
        faults.slow_step(plan, step)
    faults.slow_step(None, 9)
    assert naps == [faults.SLOWRANK_DELAY_S] * 3
    # Under a group only the chosen rank (default: the last) sleeps.
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_world_size', lambda group=None: 4)
    for rank, want in ((0, 0), (3, 1)):
        monkeypatch.setattr(dist, 'get_rank', lambda group=None, r=rank: r)
        naps.clear()
        faults.slow_step(plan, 5)
        assert len(naps) == want
    monkeypatch.setenv(faults.SLOWRANK_RANK_ENV, '0')
    naps.clear()
    faults.slow_step(plan, 5)
    assert naps == []


# ---------------------------------------------------------------------------
# The canonical gather and the repack
# ---------------------------------------------------------------------------

def _rank_view(kfac, rows, cols, rank, distribute=None):
    """What ``DistributedKFAC`` holds of rank ``rank`` of a ``rows x
    cols`` grid, without a process group: its placement and methods."""
    view = D.DistributedKFAC.__new__(D.DistributedKFAC)
    view.kfac, view.specs, view.device = kfac, kfac.specs, kfac.device
    view.n_rows, view.n_cols = rows, cols
    view.rows_per_slice, view.num_slices, view.seq_parallel = rows, 1, 1
    view.row, view.col = divmod(rank, cols)
    view.distribute_layer_factors = (cols > 1 if distribute is None
                                     else distribute)
    view.assignment = D.assign_work(
        kfac, rows, cols,
        distribute_layer_factors=view.distribute_layer_factors)
    view._factor_dims = D.factor_dims(kfac)
    view._bucket_mixed = {dim: False for dim in view.assignment.buckets}
    return view


def _factor_mats(kfac, seed=0):
    """Random per-factor ``{(layer, side): {'Q', 'd'}}`` entries."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (a, g) in D.factor_dims(kfac).items():
        for side, dim in (('A', a), ('G', g)):
            out[(name, side)] = {
                'Q': rng.standard_normal((dim, dim)).astype(np.float32),
                'd': rng.standard_normal(dim).astype(np.float32)}
    return out


def _jax_stacks(mats, assignment):
    """The JAX package's global ``(n_rows * S, ...)`` stacks."""
    stacks = {}
    for dim, plan in assignment.buckets.items():
        s = plan.slots_per_row
        arrs = {'Q': np.zeros((assignment.n_rows * s, dim, dim), np.float32),
                'd': np.zeros((assignment.n_rows * s, dim), np.float32)}
        for (name, which), slot in plan.slot.items():
            g = assignment.layer_row[name] * s + slot
            for k in arrs:
                arrs[k][g] = mats[(name, which)][k]
        stacks[str(dim)] = arrs
    return stacks


def _port_rank_sds(mats, kfac, rows, cols, distribute=None):
    """Every rank's ``state_dict`` part of a ``rows x cols`` world: its
    row's ``(S, ...)`` stacks (padding zero) and grid position."""
    sds = []
    for rank in range(rows * cols):
        view = _rank_view(kfac, rows, cols, rank, distribute)
        canon = {k: {n: torch.from_numpy(m) for n, m in v.items()}
                 for k, v in mats.items()}
        sds.append({'inv_stacks': reshard.repack_canonical(canon, view),
                    'inv_layout': view._layout()})
    return sds


def _padding_present(assignment) -> bool:
    return any(plan.slots_per_row * assignment.n_rows > len(plan.slot)
               for plan in assignment.buckets.values())


@pytest.mark.parametrize('grid,distribute', [
    ((2, 2), None), ((2, 1), None), ((1, 1), None), ((2, 2), False),
    ((1, 4), None)], ids=str)
def test_gather_canonical_matches_jax(nets, grid, distribute):
    jk, jparams, kfac = nets
    rows, cols = grid
    mats = _factor_mats(kfac, seed=rows * 10 + cols)
    jassign = JD.assign_work(jk, jparams, rows, cols,
                             distribute_layer_factors=distribute)
    want = jreshard.gather_canonical(_jax_stacks(mats, jassign), jassign)
    topo = topology.TopologySpec(rows * cols, rows * cols, rows, cols,
                                 distribute_layer_factors=(
                                     cols > 1 if distribute is None
                                     else distribute))
    assign = reshard.saved_assignment(kfac, topo)
    if grid == (2, 2):
        assert _padding_present(assign)
    got = reshard.gather_canonical(
        _port_rank_sds(mats, kfac, rows, cols, distribute), assign)
    assert set(got) == set(want)
    for key, entry in want.items():
        for k, m in entry.items():
            assert np.array_equal(got[key][k].numpy(), np.asarray(m)), key


def test_gather_rejects_stacks_against_their_record(nets):
    kfac = nets[2]
    sds = _port_rank_sds(_factor_mats(kfac), kfac, 2, 2)
    # A grid record of 4 x 1 against stacks written for 2 x 2.
    wrong = topology.TopologySpec(4, 4, 4, 1)
    with pytest.raises(ValueError, match='recorded topology'):
        reshard.gather_canonical(sds, reshard.saved_assignment(kfac, wrong))
    # Slot counts that disagree with the record.
    bad = [{**sd, 'inv_stacks': {d: {k: t[:-1] for k, t in e.items()}
                                 for d, e in sd['inv_stacks'].items()}}
           for sd in sds]
    topo = topology.TopologySpec(4, 4, 2, 2)
    with pytest.raises(ValueError, match='recorded topology'):
        reshard.gather_canonical(bad, reshard.saved_assignment(kfac, topo))


def test_repack_round_trips_are_lossless(nets):
    """2 x 2 -> 2 x 1 -> 2 x 2 and 2 x 2 -> 1 x 1 (a single-device
    ``KFAC``'s inverses) -> 2 x 2 give every rank's row stacks back bit
    for bit, padding included."""
    kfac = nets[2]
    mats = _factor_mats(kfac, seed=7)
    start = _port_rank_sds(mats, kfac, 2, 2)
    t22 = topology.TopologySpec(4, 4, 2, 2)
    canon = reshard.gather_canonical(start, reshard.saved_assignment(
        kfac, t22))
    mid = [{'inv_stacks': reshard.repack_canonical(canon, v),
            'inv_layout': v._layout()}
           for v in (_rank_view(kfac, 2, 1, r) for r in range(2))]
    t21 = topology.TopologySpec(2, 2, 2, 1, distribute_layer_factors=False)
    canon21 = reshard.gather_canonical(mid, reshard.saved_assignment(
        kfac, t21))
    inverses = reshard.inverses_of_canonical(canon, {}, {}, kfac)
    assert inverses is not None
    canon11, diag, grouped = reshard.canonical_of_inverses(inverses, kfac)
    assert diag == {} and grouped == {}
    for back in (canon21, canon11):
        for rank, sd in enumerate(start):
            got = reshard.repack_canonical(back, _rank_view(kfac, 2, 2, rank))
            for d, e in sd['inv_stacks'].items():
                for k, t in e.items():
                    assert torch.equal(got[d][k], t), (rank, d, k)


def test_cross_config_and_accumulator_drop_match_jax(monkeypatch, nets):
    """A bundle whose inverse representation is not the live
    configuration's drops its inverse groups (JAX's
    ``_stacks_match_config``); across a change of world the accumulator
    falls back to its seed and ``frozen_factors`` pass, as the JAX
    ``_overlay_overlap_state`` leaves them."""
    jk, jparams, kfac = nets
    mats = _factor_mats(kfac)
    sds = _port_rank_sds(mats, kfac, 2, 2)
    factors = {n: {s: torch.eye(d) for s, d in zip('AG', dims)}
               for n, dims in D.factor_dims(kfac).items()}
    ones = {n: {s: torch.ones_like(t) for s, t in f.items()}
            for n, f in factors.items()}
    for sd in sds:
        sd.update(step=4, factors=factors, inv_chunk_phase=1,
                  factor_accum=ones, accum_decay=torch.tensor(0.5),
                  frozen_factors=ones, diag_inv={}, grouped_inv={})
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_world_size', lambda group=None: 2)
    live = _rank_view(kfac, 2, 1, 1)
    saved = topology.TopologySpec(4, 4, 2, 2)
    doctored = [{**sd, 'inv_stacks': {d: {'inv': e['Q']}
                                      for d, e in sd['inv_stacks'].items()}}
                for sd in sds]
    out = reshard.reshard_state_dict(doctored, saved, live, rank=1)
    # JAX on the same doctored layout (its own global stacks).
    mesh = JD.make_kfac_mesh(jax.devices()[:4], grad_worker_fraction=0.5,
                             comm_method='hybrid-opt')
    jdk = JD.DistributedKFAC(jk, mesh, jparams)
    jsd = {'step': 4, 'factors': {}, 'diag_inv': {}, 'grouped_inv': {},
           'inv_stacks': {d: {'inv': e['Q']} for d, e in _jax_stacks(
               mats, jdk.assignment).items()}}
    jsd['factors'] = {n: {} for n in jk.specs}
    jout = jreshard.reshard_state_dict(
        jsd, jtopo.TopologySpec(2, 2, 2, 1, distribute_layer_factors=False),
        jdk, jparams)
    for key in ('inv_stacks', 'diag_inv', 'grouped_inv'):
        assert (key in out) == (key in jout) == False  # noqa: E712
    assert out['step'] == 4 and out['inv_chunk_phase'] == 1
    # The accumulator drop: the port's reshard + load against JAX's overlay.
    jstate = {'factors': {'a': jnp.eye(3)},
              'factor_accum': {'a': jnp.zeros((2, 3, 3))},
              'accum_decay': jnp.ones((), jnp.float32),
              'frozen_factors': {'a': jnp.eye(3)}}
    jback = j_overlay(jstate, {'factor_accum': {'a': jnp.ones((4, 3, 3))},
                               'accum_decay': 0.5,
                               'frozen_factors': {'a': 2 * jnp.eye(3)}})
    assert float(jback['accum_decay']) == 1.0
    assert not np.asarray(jback['factor_accum']['a']).any()
    seed = {'factors': factors,
            'factor_accum': {n: {s: torch.zeros_like(t) for s, t in f.items()}
                             for n, f in factors.items()},
            'accum_decay': torch.ones(()), 'frozen_factors': factors}
    back = overlay_overlap_state(seed, out)
    assert 'factor_accum' not in out and float(back['accum_decay']) == 1.0
    assert not any(t.any() for f in back['factor_accum'].values()
                   for t in f.values())
    assert all(torch.equal(back['frozen_factors'][n][s], ones[n][s])
               for n in ones for s in ones[n])
    # On the same world size the rank keeps its own accumulator.
    monkeypatch.setattr(dist, 'get_world_size', lambda group=None: 4)
    same = reshard.reshard_state_dict(sds, saved,
                                      _rank_view(kfac, 2, 2, 1), rank=1)
    assert float(same['accum_decay']) == 0.5
    assert all(torch.equal(same['inv_stacks'][d][k], t)
               for d, e in sds[1]['inv_stacks'].items()
               for k, t in e.items())


def test_reshard_rejects_other_layers(nets):
    kfac = nets[2]
    sds = [{'factors': {'other': {}}, 'step': 0}]
    with pytest.raises(ValueError, match='do not match registered'):
        reshard.reshard_state_dict(sds, topology.TopologySpec(1, 1, 1, 1),
                                   kfac)
    # A factor-only bundle passes through.
    only = {'factors': {n: {} for n in kfac.specs}, 'step': 3}
    assert reshard.reshard_state_dict(
        [only], topology.TopologySpec(1, 1, 1, 1), kfac) == only


# ---------------------------------------------------------------------------
# Cross-world restore and the resume's advice
# ---------------------------------------------------------------------------

def _two_rank_bundle(mgr, label, topo):
    """A bundle as a 2-rank world writes it (``bundle.pt`` and two rank
    files, each stamped)."""
    from distributed_kfac_pytorch_tpu_torch.resilience import integrity
    root = os.path.join(mgr.directory, str(label))
    os.makedirs(root)
    tree = ckpt.bundle_state({'w': torch.ones(2)}, {}, {}, {},
                             integrity='template', topology=topo,
                             step=label, epoch=0, step_in_epoch=label,
                             data_seed=0)
    tree = {k: v for k, v in tree.items()
            if k not in ckpt.RANK_KEYS}
    integrity.stamp(tree)
    torch.save(tree, os.path.join(root, ckpt.BUNDLE_FILE))
    for r in range(2):
        part = {'kfac': {'step': label, 'r': torch.tensor(r)},
                'extra_vars': {'dropout_generator': torch.tensor(r),
                               'loss_scale': torch.tensor(8.0)},
                'scalars': {'step': label, 'integrity_checksum': 0}}
        integrity.stamp(part)
        torch.save(part, os.path.join(root, ckpt.RANK_FILE.format(r)))


def test_cross_world_restore(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / 'steps'))
    _two_rank_bundle(mgr, 3, topology.TopologySpec(2, 2, 1, 2))
    _two_rank_bundle(mgr, 5, None)
    with pytest.raises(ckpt.WorldMismatch, match='2 rank'):
        mgr.restore(3)
    tree = mgr.restore(3, elastic=True)
    assert [int(p['kfac']['r']) for p in tree['ranks']] == [0, 1]
    assert 'kfac' not in tree and tree['scalars']['topo_devices'] == 2
    with pytest.raises(ckpt.WorldMismatch, match='records no topology'):
        mgr.restore(5, elastic=True)
    # A rank the saving world did not have keeps rank 0's loss scale and
    # leaves its dropout generator to its own seed.
    out = reshard.ElasticResume(None).reshard_tree(
        tree, topology.TopologySpec(2, 2, 1, 2))
    assert set(out['extra_vars']) == {'dropout_generator', 'loss_scale'}
    assert int(out['kfac']['r']) == 0


def test_resume_advice_names_world_size_only_without_a_record(tmp_path):
    sm = ckpt.CheckpointManager(str(tmp_path / 'steps'))
    em = ckpt.CheckpointManager(str(tmp_path))
    _two_rank_bundle(sm, 5, None)
    args = argparse.Namespace(no_resume=False, resume_step=5, seed=0,
                              checkpoint_dir=str(tmp_path))
    with pytest.raises(SystemExit, match='configuration or world size'):
        resil_cli.resume(args, em, sm,
                         elastic=reshard.ElasticResume(None))
    # A bundle with the record restores on this world of one.
    _two_rank_bundle(sm, 7, topology.TopologySpec(2, 2, 1, 2))
    args.resume_step = 7
    tree, epoch, offset, source = resil_cli.resume(
        args, em, sm, elastic=reshard.ElasticResume(None))
    assert (epoch, offset, source) == (0, 7, 'step')
    assert int(tree['kfac']['r']) == 0


# ---------------------------------------------------------------------------
# The chaos harness with tiny children
# ---------------------------------------------------------------------------

def _chaos_child(tmp_path):
    """A child that records its world and exits the relaunch code on its
    first launch."""
    return (
        'import os, sys\n'
        f'd = {str(tmp_path)!r}\n'
        "rank, world = os.environ.get('RANK', '-'), "
        "os.environ.get('WORLD_SIZE', '-')\n"
        "n = len([f for f in os.listdir(d) if f.startswith('seen')])\n"
        "open(os.path.join(d, f'seen.{rank}.{world}.' + str(os.getpid())), "
        "'w').write(os.environ.get('KFAC_CHAOS', '') + '|' + "
        "os.environ.get('KFAC_NUM_SLICES', ''))\n"
        "first = not os.path.exists(os.path.join(d, 'once'))\n"
        "if rank in ('0', '-') and first:\n"
        "    import time; time.sleep(0.3)\n"
        "    open(os.path.join(d, 'once'), 'w').close()\n"
        f"sys.exit({RELAUNCH_EXIT_CODE} if first else 0)\n")


def _seen(tmp_path):
    return sorted(f.split('.')[1:3] + [open(tmp_path / f).read()]
                  for f in os.listdir(tmp_path) if f.startswith('seen'))


def test_chaos_resize_relaunches_at_the_new_world(tmp_path):
    from distributed_kfac_pytorch_tpu_torch.resilience import chaos
    rc = chaos.main(['resize@1->2', '--nproc', '3', '--relaunch', '1', '--',
                     sys.executable, '-c', _chaos_child(tmp_path)])
    assert rc == 0
    seen = _seen(tmp_path)
    assert [s for s in seen if s[1] == '3'] == [
        [str(r), '3', 'resize@1->2|'] for r in range(3)]
    assert [s for s in seen if s[1] == '2'] == [
        [str(r), '2', '|'] for r in range(2)]


def test_chaos_slice_loss_and_its_guard(tmp_path, monkeypatch):
    from distributed_kfac_pytorch_tpu_torch.resilience import chaos
    monkeypatch.setenv('KFAC_NUM_SLICES', '2')
    rc = chaos.main(['slice-loss@1->1', '--nproc', '4', '--relaunch', '1',
                     '--keep-faults', '--', sys.executable, '-c',
                     _chaos_child(tmp_path)])
    assert rc == 0
    assert [s for s in _seen(tmp_path) if s[1] == '2'] == [
        [str(r), '2', 'slice-loss@1->1|1'] for r in range(2)]
    monkeypatch.delenv('KFAC_NUM_SLICES')
    os.unlink(tmp_path / 'once')
    with pytest.raises(SystemExit, match='KFAC_NUM_SLICES'):
        chaos.main(['slice-loss@1->1', '--nproc', '2', '--relaunch', '1',
                    '--', sys.executable, '-c', _chaos_child(tmp_path)])
