"""The CLIs' autotune flags (PyTorch port of
``distributed_kfac_pytorch_tpu/autotune/cli.py``).

The three CLIs expose the same two features through this module:

    add_autotune_args(parser)     # --tuned-config, --cadence-backoff and
                                  # its envelope (--backoff-*)
    cfg, events = maybe_apply_tuned(args, cfg, device)  # fail-closed
    policy = make_cadence_policy(args)                  # or None

``maybe_apply_tuned`` runs after the process group is up (the artifact's
world is compared with the live one) and before the optimizer is built
(the tuned knobs feed ``OptimConfig``); its queued events go into the
metrics sink with ``autotune.emit_events(sink, events)``, so the apply or
fall-back decision is always on the record (``engine.apply_autotune``
does both). The policy rides ``engine.Observers`` (``make_observers``).
"""

from __future__ import annotations

from distributed_kfac_pytorch_tpu_torch.autotune import driver as _driver
from distributed_kfac_pytorch_tpu_torch.autotune import policy as _policy


def add_autotune_args(p) -> None:
    p.add_argument('--tuned-config', default=None, metavar='PATH',
                   help='load a TUNED_<workload>.json (python -m '
                        'distributed_kfac_pytorch_tpu_torch.autotune) and '
                        'overlay its tuned knobs on this run. FAIL-CLOSED: '
                        'an unreadable / mismatched-platform / '
                        'mismatched-topology artifact falls back to the '
                        'flag defaults and logs one autotune_fallback '
                        'event in the metrics stream')
    p.add_argument('--cadence-backoff', action='store_true',
                   help='straggler-aware factor-cadence backoff: when the '
                        'barrier probe shows sustained skew, stretch the '
                        'factor-update cadence within a bounded envelope '
                        '(and relax when the world recovers). Under a '
                        'process group it arms the per-step barrier probe '
                        '(the same device syncs as --straggler-shards) '
                        "and every rank acts on the world's largest wait; "
                        'in a process alone there is no probe and the '
                        'policy never stretches. Off by default: the '
                        'default path is unchanged')
    p.add_argument('--backoff-skew-ms', type=float, default=5.0,
                   help='barrier wait above this counts as skew')
    p.add_argument('--backoff-sustain-steps', type=int, default=8,
                   help='consecutive skewed steps before stretching')
    p.add_argument('--backoff-recover-steps', type=int, default=32,
                   help='consecutive calm steps before relaxing')
    p.add_argument('--backoff-max-stretch', type=int, default=4,
                   help='bound on the effective factor-interval '
                        'multiplier (factor staleness stays bounded)')


def maybe_apply_tuned(args, cfg, device) -> tuple:
    """``(cfg, events)``: overlay ``--tuned-config`` fail-closed, against
    the platform of ``device`` (``driver.platform_of``) and the live world
    (``driver.live_world``). ``events`` must be flushed into the metrics
    sink (``autotune.emit_events``). Requires the K-FAC step: a tuned
    artifact cannot apply to the SGD baseline."""
    if not getattr(args, 'tuned_config', None):
        return cfg, []
    if cfg.kfac_inv_update_freq <= 0:
        raise SystemExit('--tuned-config requires the K-FAC step '
                         '(--kfac-update-freq > 0)')
    knobs, events = _driver.load_tuned_config(
        args.tuned_config, platform=_driver.platform_of(device),
        world=_driver.live_world())
    if knobs is None:
        return cfg, events
    new_cfg, err = _driver.apply_tuned(cfg, knobs)
    if err is not None:
        return cfg, [{'event': 'autotune_fallback',
                      'path': str(args.tuned_config),
                      'reason': 'invalid_merge', 'error': err}]
    return new_cfg, events


def make_cadence_policy(args):
    """The in-run policy (None when ``--cadence-backoff`` is absent)."""
    if not getattr(args, 'cadence_backoff', False):
        return None
    return _policy.StragglerCadencePolicy(_policy.BackoffConfig(
        skew_threshold_ms=args.backoff_skew_ms,
        sustain_steps=args.backoff_sustain_steps,
        recover_steps=args.backoff_recover_steps,
        max_stretch=args.backoff_max_stretch))
