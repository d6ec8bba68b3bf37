"""Self-healing training: the fault-response escalation ladder (PyTorch
port of ``distributed_kfac_pytorch_tpu/resilience/selfheal.py``).

The :class:`SelfHealController` reads the metrics stream and answers a
fault in the process before the relaunch loop has to:

  1. **Skip-window**: the non-finite guard (``KFAC(nonfinite_guard=
     True)``, forced on by ``--selfheal``) drops a non-finite candidate
     factor update and counts it in ``kfac/nonfinite_skips``; the ladder
     reads the count.
  2. **Damping escalation**: on bad windows (a non-finite signal, or a
     loss above ``diverge_ratio`` times its running reference) the step's
     damping is multiplied by ``damping_factor``, and divided back one
     notch per clean window.
  3. **Per-bucket quarantine**: when bad windows persist and a scan of
     the factors finds the non-finite layers, their precondition shape
     buckets are gated to the raw gradient (``KFAC.precondition(
     gates=)``), the bucket's factors reset to their initial seeds and
     re-accumulate; once they are finite and an inverse firing has
     consumed them (the probe), the bucket is re-admitted.
  4. **In-process rollback**: when quarantine cannot attribute or clear
     the fault, :class:`Rollback` leaves the epoch; the epoch loop
     restores the newest step bundle at or before the fault's onset that
     verifies and holds finite K-FAC state (:func:`rollback_restore`) and
     trains on in the same process.
  5. Past ``max_rollbacks`` (or with no such bundle)
     :class:`SelfHealExhausted` ends the process, for the relaunch loop.

Cost: per step the controller does host arithmetic. Its one host read
is at each window boundary (every ``check_every`` steps): the window's
last metrics, read in one transfer; the factor scan runs only while a
window is bad or a quarantined bucket is up for its probe. Damping is a
host float in ``hyper``: the escalated value reaches the step as the
plain one does. The gates are 0-dim device tensors (one cached tensor
for 1 and one for 0), so flipping a gate copies nothing to the card.
With the ladder off the engine runs the plain step, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist


class Rollback(RuntimeError):
    """Raised by the controller when the ladder reaches rung 4; the epoch
    loop catches it, restores (:func:`handle_rollback`) and trains on."""

    def __init__(self, global_step: int, onset_step: int, reason: str):
        super().__init__(
            f'self-heal rollback requested at step {global_step} '
            f'(fault onset ~step {onset_step}): {reason}')
        self.global_step = int(global_step)
        self.onset_step = int(onset_step)
        self.reason = reason
        self.partial: dict | None = None


class SelfHealExhausted(RuntimeError):
    """The ladder is out of rungs (the rollback budget is spent, or no
    bundle restores): the process ends for the relaunch loop."""


@dataclasses.dataclass
class SelfHealConfig:
    """Knobs of the escalation ladder (the JAX package's, with its
    defaults). ``check_every`` is the window in optimizer steps."""
    check_every: int = 10
    # Rung 2: damping escalation.
    escalate_after: int = 1
    damping_factor: float = 10.0
    damping_max_mult: float = 1e4
    diverge_ratio: float = 10.0
    loss_ema_alpha: float = 0.5
    # On a diverged window the loss reference grows by at most this
    # factor (the spiked loss must not vouch for itself): a sustained
    # plateau keeps flagging and can reach the rollback rung.
    diverge_adapt: float = 1.2
    # Rung 3: per-bucket quarantine.
    quarantine: bool = True
    quarantine_after: int = 2
    readmit_windows: int = 2
    # Rung 4: in-process rollback.
    rollback_after: int = 5
    max_rollbacks: int = 1

    def __post_init__(self):
        if self.check_every < 1:
            raise ValueError(f'{self.check_every=} must be >= 1')
        if self.damping_factor <= 1.0:
            raise ValueError(f'{self.damping_factor=} must be > 1')
        if self.diverge_adapt <= 1.0:
            raise ValueError(f'{self.diverge_adapt=} must be > 1')
        if not (self.escalate_after >= 1
                and self.quarantine_after >= 1
                and self.rollback_after >= 1):
            raise ValueError('escalate_after/quarantine_after/'
                             'rollback_after must be >= 1')
        if self.rollback_after <= self.quarantine_after and \
                self.quarantine:
            raise ValueError(
                f'{self.rollback_after=} must exceed '
                f'{self.quarantine_after=} — quarantine needs at least '
                'one window to act before the ladder skips past it')


def bucket_layer_map(kfac) -> dict[str, list[str]]:
    """Precondition shape-bucket key (``observability.metrics.shape_key``
    of the gradient matrix) -> the registered layers in it, from the
    parameter shapes alone (a ``KFAC`` or a ``DistributedKFAC``)."""
    from distributed_kfac_pytorch_tpu_torch import layers as L
    from distributed_kfac_pytorch_tpu_torch.observability import \
        metrics as obs_metrics
    kfac = getattr(kfac, 'kfac', kfac)
    params = {n: torch.empty(p.shape, device='meta')
              for n, p in kfac.model.named_parameters()}
    out: dict[str, list[str]] = {}
    for name, spec in kfac.specs.items():
        key = obs_metrics.shape_key(L.grads_to_matrix(
            spec, kfac._layer_params(name, params)).shape)
        out.setdefault(key, []).append(name)
    return out


def _seed_like(t: torch.Tensor) -> torch.Tensor:
    """The initial seed of one factor tensor: identity blocks for square
    matrices (stacked for a grouped conv), ones for a diagonal factor;
    shape, dtype and device kept."""
    if t.dim() >= 2 and t.shape[-1] == t.shape[-2]:
        eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device)
        return eye.expand(t.shape).clone()
    return torch.ones_like(t)


#: Metrics the window boundary reads.
_READ_KEYS = ('loss', 'kfac/nonfinite_skips', 'kfac/grad_norm',
              'kfac/precond_norm', 'kfac/inv_updates',
              'kfac/inv_chunk_firings')


def read_scalars(metrics: dict, keys=_READ_KEYS) -> dict[str, float]:
    """The float values of ``keys`` in ``metrics`` (NaN for a missing
    one): the device tensors among them are read in one transfer."""
    vals: dict[str, float] = {}
    tensors = []
    for k in keys:
        v = metrics.get(k)
        if isinstance(v, torch.Tensor):
            tensors.append((k, v))
        elif v is None:
            vals[k] = float('nan')
        else:
            vals[k] = float(v)
    if tensors:
        read = torch.stack([v.detach().reshape(()).float().to(
            tensors[0][1].device) for _, v in tensors]).tolist()
        vals.update(zip((k for k, _ in tensors), read))
    return vals


class SelfHealController:
    """The ladder's host-side state machine, driven by the metrics stream
    (``training.engine`` calls :meth:`adjust_hyper` before each step and
    :meth:`observe` after it).

    ``bucket_layers``: :func:`bucket_layer_map`; None disables the
    quarantine rung. When given, :meth:`adjust_hyper` puts a
    ``bucket_gate`` entry (bucket -> 0-dim device tensor, 1 = normal) in
    every step's hyper. ``device``: where the gate tensors live.
    """

    def __init__(self, config: SelfHealConfig | None = None, *,
                 bucket_layers: dict[str, list[str]] | None = None,
                 sink=None, device=None):
        self.config = config or SelfHealConfig()
        self.bucket_layers = bucket_layers
        self.sink = sink
        self.damping_mult = 1.0
        self.gates: dict[str, float] = {
            k: 1.0 for k in (bucket_layers or {})}
        self.pending_events: list[dict] = []
        self.rollbacks = 0
        self._gate_values = None
        if bucket_layers is not None:
            dev = torch.device(device if device is not None else 'cpu')
            self._gate_values = {
                v: torch.full((), v, dtype=torch.float32, device=dev)
                for v in (0.0, 1.0)}
        self._consec_bad = 0
        self._onset_step: int | None = None
        self._last_skips = 0.0
        self._loss_ema: float | None = None
        self._last_inv_work = 0.0
        # bucket -> {'since': windows gated, 'inv_work_at': firings when
        # gated} for the readmission probe.
        self._quarantined: dict[str, dict] = {}

    # -- the per-step hooks --------------------------------------------

    def adjust_hyper(self, hyper: dict) -> dict:
        """This step's hyperparameters: the escalated damping and the
        quarantine gates. Host dict work, every step."""
        out = dict(hyper)
        if self.damping_mult != 1.0:
            out['damping'] = hyper['damping'] * self.damping_mult
        if self.bucket_layers is not None:
            out['bucket_gate'] = {k: self._gate_values[v]
                                  for k, v in self.gates.items()}
        return out

    def observe(self, state, metrics: dict) -> None:
        """Take one finished step (``state.step`` still the step just
        run). Host arithmetic except at window boundaries; may reset
        quarantined layers' factors in ``state.kfac_state`` and may raise
        :class:`Rollback`."""
        step = int(state.step)
        if (step + 1) % self.config.check_every:
            return
        self._boundary(step, state, metrics)

    def drain_events(self) -> list[dict]:
        out, self.pending_events = self.pending_events, []
        return out

    # -- window-boundary logic -----------------------------------------

    def _boundary(self, step: int, state, metrics: dict) -> None:
        cfg = self.config
        vals = read_scalars(metrics)
        loss = vals['loss']
        skips = vals['kfac/nonfinite_skips']
        grad_norm = vals['kfac/grad_norm']
        precond_norm = vals['kfac/precond_norm']
        # Inverse work = monolithic firings + chunk firings; only both
        # missing means no signal.
        inv_u = vals['kfac/inv_updates']
        inv_c = vals['kfac/inv_chunk_firings']
        if math.isnan(inv_u) and math.isnan(inv_c):
            inv_work = float('nan')
        else:
            inv_work = ((0.0 if math.isnan(inv_u) else inv_u)
                        + (0.0 if math.isnan(inv_c) else inv_c))

        nonfinite = (
            (not math.isnan(skips) and skips > self._last_skips)
            or not math.isfinite(loss)
            or (not math.isnan(grad_norm)
                and not math.isfinite(grad_norm))
            or (not math.isnan(precond_norm)
                and not math.isfinite(precond_norm)))
        if not math.isnan(skips):
            self._last_skips = skips
        diverged = (not nonfinite and math.isfinite(loss)
                    and self._loss_ema is not None
                    and loss > cfg.diverge_ratio * self._loss_ema)
        if diverged:
            self._loss_ema *= cfg.diverge_adapt
        elif math.isfinite(loss):
            a = cfg.loss_ema_alpha
            self._loss_ema = (loss if self._loss_ema is None
                              else (1 - a) * self._loss_ema + a * loss)

        if not math.isnan(inv_work):
            self._last_inv_work = inv_work
        if nonfinite or diverged:
            self._bad_window(step, state,
                             'nonfinite' if nonfinite else 'diverge',
                             loss)
        else:
            self._clean_window(step)
        self._probe_quarantined(step, state, inv_work)

    def _bad_window(self, step: int, state, kind: str,
                    loss: float) -> None:
        cfg = self.config
        self._consec_bad += 1
        if self._onset_step is None:
            # The fault began inside this window: the rollback must not
            # restore a bundle saved after its start.
            self._onset_step = max(0, step - cfg.check_every)
        if self._consec_bad >= cfg.escalate_after and \
                self.damping_mult < cfg.damping_max_mult:
            self.damping_mult = min(
                self.damping_mult * cfg.damping_factor,
                cfg.damping_max_mult)
            self._event('selfheal_escalate', global_step=step,
                        kind=kind, damping_mult=self.damping_mult,
                        bad_windows=self._consec_bad)
        if cfg.quarantine and self.bucket_layers is not None \
                and self._consec_bad >= cfg.quarantine_after:
            self._quarantine_bad_buckets(step, state)
        if self._consec_bad >= cfg.rollback_after:
            self._request_rollback(step, kind, loss)

    def _clean_window(self, step: int) -> None:
        cfg = self.config
        self._consec_bad = 0
        if not self._quarantined:
            self._onset_step = None
        if self.damping_mult > 1.0:
            self.damping_mult = max(
                1.0, self.damping_mult / cfg.damping_factor)
            self._event('selfheal_deescalate', global_step=step,
                        damping_mult=self.damping_mult)

    # -- rung 3: quarantine --------------------------------------------

    def _scan_factors(self, kfac_state: dict) -> dict[str, bool]:
        """layer -> its factors are all finite (host reads; only while a
        window is bad or a bucket is up for its probe)."""
        from distributed_kfac_pytorch_tpu_torch.resilience import \
            integrity as integrity_lib
        return {name: integrity_lib.finite_ok(entry)
                for name, entry in kfac_state.get('factors', {}).items()}

    def _quarantine_bad_buckets(self, step: int, state) -> None:
        finite = self._scan_factors(state.kfac_state)
        for bucket, layers in self.bucket_layers.items():
            if bucket in self._quarantined or \
                    self.gates.get(bucket, 1.0) == 0.0:
                continue
            bad = [n for n in layers if not finite.get(n, True)]
            if not bad:
                continue
            self.gates[bucket] = 0.0
            self._quarantined[bucket] = {
                'since': 0, 'inv_work_at': self._last_inv_work}
            state.kfac_state = reset_layers(state.kfac_state, layers)
            self._event('selfheal_quarantine', global_step=step,
                        bucket=bucket, layers=','.join(sorted(layers)),
                        nonfinite_layers=','.join(sorted(bad)))

    def _probe_quarantined(self, step: int, state,
                           inv_work: float) -> None:
        """Rung 3's exit: a bucket is re-admitted once its re-accumulated
        factors are finite and an inverse firing (monolithic or chunk)
        has consumed them."""
        if not self._quarantined:
            return
        cfg = self.config
        finite = None
        for bucket in list(self._quarantined):
            q = self._quarantined[bucket]
            q['since'] += 1
            if q['since'] < cfg.readmit_windows:
                continue
            refired = (not math.isnan(inv_work)
                       and inv_work > q['inv_work_at'])
            if not refired:
                continue
            if finite is None:
                finite = self._scan_factors(state.kfac_state)
            if all(finite.get(n, True) for n in self.bucket_layers[bucket]):
                self.gates[bucket] = 1.0
                windows = q['since']
                del self._quarantined[bucket]
                self._event('selfheal_readmit', global_step=step,
                            bucket=bucket, windows=windows)
        if not self._quarantined and self._consec_bad == 0:
            self._onset_step = None

    # -- rung 4: rollback ----------------------------------------------

    def _request_rollback(self, step: int, kind: str,
                          loss: float) -> None:
        cfg = self.config
        reason = (f'{self._consec_bad} consecutive bad windows '
                  f'(last: {kind}, loss={loss:.4g}, '
                  f'damping_mult={self.damping_mult:g})')
        if self.rollbacks >= cfg.max_rollbacks:
            raise SelfHealExhausted(
                f'self-heal ladder exhausted at step {step}: {reason} '
                f'after {self.rollbacks} rollback(s) — ending the process '
                'for the relaunch loop, the ladder\'s last rung')
        self.rollbacks += 1
        onset = self._onset_step if self._onset_step is not None else step
        raise Rollback(step, onset, reason)

    def after_rollback(self, restored_step: int) -> None:
        """Re-arm on the restored state: gates lift, damping resets, the
        window counters clear. The rollback budget is kept, so a
        recurring fault ends in the relaunch loop."""
        self._consec_bad = 0
        self._onset_step = None
        self._last_skips = 0.0
        self._last_inv_work = 0.0
        self._loss_ema = None
        self.damping_mult = 1.0
        self._quarantined.clear()
        for k in self.gates:
            self.gates[k] = 1.0

    def _event(self, name: str, **data) -> None:
        self.pending_events.append({'event': name, **data})


def reset_layers(kfac_state: dict, layers) -> dict:
    """The state with the named layers' factors (and their stale
    snapshot) back at the initial seeds and their deferred accumulator at
    zero: quarantined layers re-accumulate from clean statistics. New
    tensors; the others are shared."""
    out = dict(kfac_state)
    for group in ('factors', 'frozen_factors'):
        if group not in out:
            continue
        entries = dict(out[group])
        for name in layers:
            if name in entries:
                entries[name] = {k: _seed_like(t)
                                 for k, t in entries[name].items()}
        out[group] = entries
    if 'factor_accum' in out:
        acc = dict(out['factor_accum'])
        for name in layers:
            if name in acc:
                acc[name] = {k: torch.zeros_like(t)
                             for k, t in acc[name].items()}
        out['factor_accum'] = acc
    return out


# ---------------------------------------------------------------------------
# Rollback restore (rung 4's epoch-loop half)
# ---------------------------------------------------------------------------

def _walk_finite(step_mgr, labels, *, sink, restore_kw):
    """The newest of ``labels`` whose bundle verifies and holds finite
    K-FAC state: ``(label, tree, quarantined)``, or ``(None, None,
    quarantined)``."""
    from distributed_kfac_pytorch_tpu_torch.resilience import \
        cli as cli_lib
    from distributed_kfac_pytorch_tpu_torch.resilience import \
        integrity as integrity_lib
    quarantined: list[str] = []
    for label in labels:
        found = cli_lib._walk_restore(step_mgr, None, kind='step',
                                      labels=[label],
                                      quarantined=quarantined,
                                      restore_kw=restore_kw, sink=sink)
        if found is None:
            continue
        label, tree = found
        if not integrity_lib.finite_ok(tree.get('kfac', {})):
            # Moved aside: it verifies, so a relaunch's resume walk would
            # restore it again after the ladder is exhausted.
            cli_lib._quarantine(sink, 'step', label,
                                'restored K-FAC state contains non-finite '
                                'values (saved after the fault?)',
                                quarantined, mgr=step_mgr)
            continue
        return label, tree, quarantined
    return None, None, quarantined


def rollback_restore(step_mgr, *, from_step: int,
                     onset_step: int | None = None, reason: str = '',
                     sink=None, device=None):
    """Restore the newest verified step bundle for an in-process
    rollback; returns ``(label, tree)`` (every tensor on ``device``).

    Candidates are the step bundles at or before ``onset_step`` (a bundle
    saved after the fault began would roll back into it); each must pass
    the manager's digest check (the resume's verified walk,
    ``resilience.cli._walk_restore``) and :func:`integrity.finite_ok` on
    its K-FAC group. A failing bundle gets a ``ckpt_quarantine`` event
    and the walk goes on; the bundle restored gets a
    ``selfheal_rollback`` event. Under a process group rank 0 walks,
    checking every rank's file, and broadcasts the label. Raises
    :class:`SelfHealExhausted` when nothing restorable remains.
    """
    labels = sorted(step_mgr.all_steps(), reverse=True)
    if onset_step is not None:
        labels = [lb for lb in labels if lb <= onset_step]
    group = dist.is_initialized() and dist.get_world_size() > 1
    kw = {'map_location': device}
    if not group or dist.get_rank() == 0:
        if group:
            kw['all_ranks'] = True
        label, tree, quarantined = _walk_finite(step_mgr, labels,
                                                sink=sink, restore_kw=kw)
        if group:
            dist.broadcast_object_list([label], src=0)
    else:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        label, quarantined = box[0], []
        tree = (step_mgr.restore(label, map_location=device)
                if label is not None else None)
    if label is None:
        raise SelfHealExhausted(
            f'rollback requested at step {from_step} but no verified '
            f'step checkpoint at or before step {onset_step} exists '
            f'({len(quarantined)} quarantined: {quarantined[:3]}...) — '
            'ending the process for the relaunch loop')
    if sink is not None:
        sink.event_record('selfheal_rollback', from_step=int(from_step),
                          to_step=int(tree['scalars']['step']),
                          label=int(label), reason=str(reason)[:300])
    return label, tree


def handle_rollback(rb: Rollback, *, ckpt, state, controller=None,
                    sink=None, device=None,
                    verbose: bool = False) -> tuple[int, int]:
    """Rung 4's recovery in the epoch loop: restore the newest verified,
    finite step bundle at or before the fault's onset into the live
    ``TrainState`` (``ckpt.load``, the resume's loader: model, optimizer,
    K-FAC state with its inverses, scheduler, extra state) and return the
    ``(epoch, step_in_epoch)`` to continue from. ``controller`` is
    re-armed and the checkpoint policy re-keyed to the restored step, so
    the replay saves bundles again. Without step bundles
    (``ckpt`` None) the ladder is exhausted."""
    if ckpt is None:
        raise SelfHealExhausted(
            f'rollback requested at step {rb.global_step} but the run '
            'keeps no step checkpoints (--checkpoint-dir) — ending the '
            'process for the relaunch loop')
    label, tree = rollback_restore(
        ckpt.step_ckpt.mgr, from_step=rb.global_step,
        onset_step=rb.onset_step, reason=rb.reason, sink=sink,
        device=device)
    epoch, offset = ckpt.load(state, tree)
    if controller is not None:
        controller.after_rollback(state.step)
    if ckpt.step_ckpt.policy is not None:
        ckpt.step_ckpt.policy.note_saved(state.step)
    if verbose:
        print(f'self-heal: rolled back in-process to verified step '
              f'checkpoint {label} (global step {state.step}, epoch '
              f'{epoch}, offset {offset}) — {rb.reason}', flush=True)
    return epoch, offset
