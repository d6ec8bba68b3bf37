"""Per-rank heartbeat leases: the liveness signal the supervisor watches
(PyTorch port of ``distributed_kfac_pytorch_tpu/resilience/heartbeat.py``;
standard library only, so a supervisor or a test child can import this
file alone).

A process that crashes reports itself (nonzero exit); one that hangs (a
wedged collective, a deadlocked host thread, an I/O stall) reports
nothing. Heartbeat leases close that gap:

  - every rank writes a small JSON lease file (``<dir>/rank<r>.lease``)
    from the train loop every N steps, with its global step, wall time,
    pid and launch incarnation; writes go to ``<path>.tmp.<pid>``, are
    fsynced and renamed over the lease, so a reader never sees a torn one;
  - the supervisor (:mod:`supervisor`) scans the directory: every lease
    stale past ``--hang-timeout`` is a hang (kill and relaunch); a subset
    of ranks stale past the failover grace while others stay fresh is a
    dead worker (relaunch on the survivors through the elastic resume).

Leases are host file I/O on the host-driven step loop, so a run with them
on equals the run with them off, bit for bit.

Clock discipline: freshness compares the lease's ``wall_time`` (the
writer's clock) with the reader's; :func:`lease_age` clamps a lease
stamped in the future to age 0, so a skewed but beating worker never
reads as hung.
"""

from __future__ import annotations

import json
import os
import time

#: Env var naming the lease directory; the supervisor sets it for its
#: child so the training CLIs heartbeat without command-line rewriting
#: (``resilience.cli.make_heartbeat`` reads it as the default for
#: ``--heartbeat-dir``).
ENV_DIR = 'KFAC_HEARTBEAT_DIR'
#: Env var carrying the supervisor's launch counter; stamped into each
#: lease so the watcher (and post-mortems) can tell which incarnation
#: a lease belongs to.
ENV_INCARNATION = 'KFAC_INCARNATION'

LEASE_SCHEMA = 1


def lease_path(directory: str, rank: int) -> str:
    """``<dir>/rank<r>.lease`` — one lease per process, overwritten in
    place (atomically) on every beat."""
    return os.path.join(directory, f'rank{int(rank)}.lease')


def write_lease(path: str, *, rank: int, step: int, incarnation: int = 0,
                clock=time.time) -> dict:
    """Atomically publish one lease (write-tmp, fsync, rename — the
    sink's discipline, so no reader ever sees a torn lease). Returns
    the record written."""
    rec = {
        'schema': LEASE_SCHEMA,
        'rank': int(rank),
        'pid': os.getpid(),
        'step': int(step),
        'wall_time': float(clock()),
        'incarnation': int(incarnation),
    }
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'w') as f:
        json.dump(rec, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return rec


def read_lease(path: str) -> dict | None:
    """One lease, or None when absent. Raises ``ValueError`` on an
    undecodable/ill-formed file — with atomic publication that means
    real corruption (or a foreign file), not a caught-mid-write race,
    so it is worth surfacing rather than treating as missing."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except FileNotFoundError:
        return None
    except json.JSONDecodeError as e:
        raise ValueError(f'{path}: undecodable lease: {e}') from e
    if not isinstance(rec, dict) or not isinstance(
            rec.get('wall_time'), (int, float)):
        raise ValueError(f'{path}: not a lease record: {rec!r}')
    return rec


def lease_age(lease: dict, now: float | None = None) -> float:
    """Seconds since the lease was written, clamped at 0.

    The clamp is the clock-skew tolerance: a lease stamped (slightly)
    in the future by a skewed writer clock reads as *fresh*, never as
    a negative age an arithmetic comparison could misorder.
    """
    if now is None:
        now = time.time()
    return max(0.0, now - float(lease['wall_time']))


def scan_leases(directory: str, incarnation: int | None = None
                ) -> tuple[dict[int, dict], dict[str, str]]:
    """All readable leases in ``directory`` plus per-file errors.

    Returns ``({rank: lease}, {filename: error})`` — an unreadable
    lease degrades to an error entry instead of failing the scan (one
    sick rank must not blind the watcher to the rest of the world).

    ``incarnation``: when given, only leases stamped with that launch
    incarnation count as live; a mixed-incarnation lease — left behind
    by an earlier launch, or by a quarantined job that shared the
    directory — degrades to an error entry instead of masquerading as
    a live rank (its stale timestamp would otherwise fire an instant
    false hang/dead-rank verdict).
    """
    leases: dict[int, dict] = {}
    errors: dict[str, str] = {}
    try:
        names = sorted(os.listdir(directory))
    except FileNotFoundError:
        return {}, {}
    for name in names:
        if not (name.startswith('rank') and name.endswith('.lease')):
            continue
        try:
            rank = int(name[len('rank'):-len('.lease')])
        except ValueError:
            continue
        try:
            lease = read_lease(os.path.join(directory, name))
        except ValueError as e:
            errors[name] = str(e)
            continue
        if lease is None:
            continue
        if incarnation is not None:
            try:
                inc = int(lease.get('incarnation', 0))
            except (TypeError, ValueError):
                # A corrupt/foreign incarnation field degrades like
                # any other unreadable lease — one sick rank must not
                # crash the watcher.
                errors[name] = (f'bad incarnation field '
                                f'{lease.get("incarnation")!r}')
                continue
            if inc != int(incarnation):
                errors[name] = (f'stale incarnation {inc} '
                                f'(watching incarnation '
                                f'{incarnation})')
                continue
        leases[rank] = lease
    return leases, errors


def clear_leases(directory: str) -> None:
    """Remove every lease (and stray lease tmp) in ``directory``.

    The supervisor calls this before each launch: leases from the
    previous incarnation are that incarnation's last words — once read
    for failure classification they must not linger, or a relaunch on
    a smaller world would immediately re-trigger the dead-rank
    detector on the old world's orphaned lease files.
    """
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return
    for name in names:
        if name.startswith('rank') and ('.lease' in name):
            try:
                os.unlink(os.path.join(directory, name))
            except FileNotFoundError:
                pass


class HeartbeatEmitter:
    """Step-loop lease writer for one rank (the engine's
    ``Observers.heartbeat``).

    ``beat(step)`` is called once per completed optimizer step; a lease
    is published when ``step % every == 0`` (stride keyed to the
    *global* step, so a resumed run keeps the same cadence) and always
    on the first call after construction (a resume at an off-stride
    step must not stay invisible for up to ``every`` steps).
    ``close()`` publishes a final lease so the last completed step is
    on disk even when the stride would have skipped it — that step
    number is what the supervisor's crash-loop detector keys on.
    """

    def __init__(self, directory: str, rank: int, *, every: int = 1,
                 incarnation: int | None = None, clock=time.time):
        if every < 1:
            raise ValueError(f'heartbeat stride must be >= 1, got {every}')
        self.directory = directory
        self.rank = int(rank)
        self.every = int(every)
        if incarnation is None:
            incarnation = int(os.environ.get(ENV_INCARNATION, '0') or 0)
        self.incarnation = int(incarnation)
        self._clock = clock
        self._last_step: int | None = None
        self._beaten = False
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        return lease_path(self.directory, self.rank)

    def beat(self, step: int) -> None:
        """Record one completed step (published every ``every`` steps)."""
        step = int(step)
        self._last_step = step
        if self._beaten and step % self.every:
            return
        self._beaten = True
        write_lease(self.path, rank=self.rank, step=step,
                    incarnation=self.incarnation, clock=self._clock)

    def close(self) -> None:
        """Publish the final lease (off-stride last step included)."""
        if self._last_step is not None:
            write_lease(self.path, rank=self.rank, step=self._last_step,
                        incarnation=self.incarnation, clock=self._clock)
