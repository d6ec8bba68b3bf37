"""Resilience: preemption-safe checkpoints, verified mid-epoch resume and
self-healing (PyTorch port of that part of
``distributed_kfac_pytorch_tpu/resilience``).

  - :mod:`preemption`: SIGTERM / SIGINT (and a sentinel file) set a flag
    the train loop polls once per step; on it the loop forces a blocking
    checkpoint save and the CLI exits with ``RELAUNCH_EXIT_CODE``.
  - :mod:`policy`: global-step checkpoints (every N steps, every S
    seconds, forced on preemption) through
    ``training.checkpoint.CheckpointManager``.
  - :mod:`dataiter`: the data-stream position ``(seed, epoch,
    step_in_epoch)`` every bundle records; the seeded pipelines replay
    the rest of an epoch with ``skip_batches``.
  - :mod:`integrity`: a content digest stamped into every bundle file
    and verified when it is read, and ``finite_ok`` for a restored
    K-FAC state.
  - :mod:`faults`: the ``KFAC_CHAOS`` fault injectors (``preempt``,
    ``crash``, ``crash-in-save``, ``corrupt-ckpt``, ``nan-batch``,
    ``corrupt-factor``, ``diverge``, ``resize``, ``slice-loss``, ``hang``,
    ``slowrank``).
  - :mod:`selfheal`: the escalation ladder (damping escalation,
    per-bucket quarantine, in-process rollback to a verified, finite
    step bundle).
  - :mod:`cli`: the CLIs' flags, and ``resume``, which walks the step
    and epoch bundles newest first, quarantines those that fail, picks
    the newest resume point and re-shards a bundle of another world
    (``elastic``).
  - :mod:`heartbeat`: per-rank liveness leases (standard library only).
  - :mod:`chaos`: run a command under a fault spec as a world of rank
    processes, relaunching it after a drain (at a new world size after
    ``resize`` / ``slice-loss``).
  - :mod:`supervisor`: crash, hang, dead-rank, capacity and straggler
    handling by relaunch, with backoff, a restart budget and crash-loop
    detection.
"""
