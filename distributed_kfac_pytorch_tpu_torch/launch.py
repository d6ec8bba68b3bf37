"""Process-group start-up and host-local data slicing (PyTorch port of
``distributed_kfac_pytorch_tpu/launch.py``).

``torchrun`` exports ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR`` / ``MASTER_PORT``; :func:`initialize_distributed` reads
them (or explicit arguments) and starts ``torch.distributed``:

    torchrun --nproc-per-node 4 -m \\
        distributed_kfac_pytorch_tpu_torch.train_cifar10_resnet

The backend is ``nccl`` on CUDA and ``gloo`` on the CPU; gloo on CUDA
tensors (several ranks sharing one card) only when asked for with
``backend='gloo'``. Every rank draws the same global batch from the same
seed and keeps its :func:`process_local_slice` (under sequence
parallelism its :func:`process_local_tile`); the JAX package's mesh
helpers (``replicate_on_mesh``, ``host_local_batch_to_global``,
``global_batches``) have no counterpart, since a rank's batch is a plain
tensor.

A world of the port is ``N`` rank processes (the JAX package's is one
process over ``N`` devices): :func:`spawn_world` starts them with the
launcher's environment, and the chaos harness and the supervisor relaunch
a job at another world size through it.
"""

from __future__ import annotations

import datetime
import os
import warnings

import torch
import torch.distributed as dist


def _env_int(name: str) -> int | None:
    value = os.environ.get(name, '')
    return int(value) if value.isdigit() else None


def _detected_world_size() -> int:
    """Process count declared by the launch environment (1 if none)."""
    for var in ('WORLD_SIZE', 'SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE'):
        n = _env_int(var)
        if n is not None:
            return n
    return 1


def _check_world_size(detected: int, actual: int) -> None:
    """Warn when the environment's declared world size disagrees with the
    initialized group's: the group wins, but a half-exported environment
    usually means some ranks are about to train alone."""
    if detected == actual:
        return
    warnings.warn(
        f'launch environment declares {detected} process(es) '
        '(WORLD_SIZE/SLURM_NTASKS/OMPI_COMM_WORLD_SIZE) but the '
        f'initialized process group has {actual}: the group wins, but '
        'check the launch chain')


def initialize_distributed(*, backend: str | None = None,
                           init_method: str | None = None,
                           rank: int | None = None,
                           world_size: int | None = None,
                           device='cuda',
                           timeout: float | None = None) -> dict:
    """Start ``torch.distributed`` (idempotent) and return
    :func:`host_metadata`.

    ``rank`` / ``world_size`` default to ``RANK`` / ``WORLD_SIZE``;
    ``init_method`` to ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``).
    With neither arguments nor a declared world the process stays single
    and nothing is started. ``backend`` defaults to ``nccl`` for a CUDA
    ``device`` (which is then ``cuda:LOCAL_RANK`` unless an index is
    given) and ``gloo`` for the CPU; ``nccl`` with the CPU raises.
    ``timeout``: seconds a collective may wait before it fails.
    """
    dev = torch.device(device)
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    if backend == 'nccl' and dev.type != 'cuda':
        raise ValueError("backend 'nccl' needs a CUDA device; use 'gloo' "
                         "with device='cpu'")
    if dist.is_initialized():
        return host_metadata()
    explicit = init_method is not None or world_size is not None
    if not explicit and _detected_world_size() == 1:
        return host_metadata()
    if rank is None:
        rank = _env_int('RANK')
    if world_size is None:
        world_size = _env_int('WORLD_SIZE')
    if rank is None or world_size is None:
        raise ValueError('initialize_distributed: rank and world size are '
                         'needed (RANK / WORLD_SIZE, or arguments)')
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('initialize_distributed: no CUDA device; pass '
                               "device='cpu' for a gloo group on the CPU")
        index = dev.index
        if index is None:
            index = _env_int('LOCAL_RANK') or 0
        torch.cuda.set_device(index)
    kwargs = {}
    if timeout is not None:
        kwargs['timeout'] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend=backend,
                            init_method=init_method or 'env://',
                            rank=rank, world_size=world_size, **kwargs)
    if not explicit:
        # Arguments override the environment by design; otherwise a
        # half-exported environment is worth a warning.
        _check_world_size(_detected_world_size(), dist.get_world_size())
    return host_metadata()


def host_metadata() -> dict:
    """This process's identity for per-rank logs."""
    import platform
    up = dist.is_initialized()
    return {'process_index': dist.get_rank() if up else 0,
            'process_count': dist.get_world_size() if up else 1,
            'hostname': platform.node(),
            'backend': dist.get_backend() if up else None,
            'local_devices': torch.cuda.device_count()}


def process_local_slice(n_global: int) -> slice:
    """Index range of this rank's share of a global batch of
    ``n_global`` (which must divide evenly over the world)."""
    return process_local_tile(n_global, 1)[0]


def process_local_tile(n_batch: int, n_seq: int, seq_parallel: int = 1
                       ) -> tuple[slice, slice]:
    """``(batch slice, sequence slice)`` of this rank's tile of a global
    ``(n_batch, n_seq)`` batch under ``seq_parallel``-way sequence
    parallelism: world rank ``r`` is K-FAC rank ``r // seq_parallel``,
    which takes its share of the sequences, and sequence index ``r %
    seq_parallel``, which takes its contiguous share of the positions. The
    sequence slice's ``start`` is the tile's ``pos_offset``. Both shares
    must divide evenly."""
    world, rank = ((dist.get_world_size(), dist.get_rank())
                   if dist.is_initialized() else (1, 0))
    if world % seq_parallel:
        raise ValueError(f'{seq_parallel=} does not divide the world of '
                         f'{world} processes')
    dp = world // seq_parallel
    if n_batch % dp:
        raise ValueError(f'global batch of {n_batch} does not divide '
                         f'evenly over {dp} (K-FAC) ranks')
    if n_seq % seq_parallel:
        raise ValueError(f'sequence of {n_seq} does not divide evenly '
                         f'over {seq_parallel} sequence ranks')
    per_b, per_t = n_batch // dp, n_seq // seq_parallel
    k, j = divmod(rank, seq_parallel)
    return (slice(k * per_b, (k + 1) * per_b),
            slice(j * per_t, (j + 1) * per_t))


#: The launcher variables :func:`spawn_world` sets for each rank.
RANK_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE',
            'MASTER_ADDR', 'MASTER_PORT')
_PORTS_TAKEN: set[int] = set()


def free_port() -> int:
    """A free localhost TCP port, never the same one twice in this
    process (worlds started at once must not share a rendezvous)."""
    import socket
    while True:
        with socket.socket() as s:
            s.bind(('localhost', 0))
            port = s.getsockname()[1]
        if port not in _PORTS_TAKEN:
            _PORTS_TAKEN.add(port)
            return port


class World:
    """The rank processes of one command, watched as one job
    (:func:`spawn_world`). :meth:`poll` is None while it runs; a rank that
    exits nonzero other than with the relaunch code ends the world (the
    others are killed) with its code; once every rank has exited, the
    relaunch code when any rank drained with it, else 0."""

    def __init__(self, procs: list):
        self.procs = procs
        self.returncode: int | None = None

    def poll(self) -> int | None:
        from distributed_kfac_pytorch_tpu_torch.resilience.preemption import \
            RELAUNCH_EXIT_CODE
        if self.returncode is not None:
            return self.returncode
        codes = [p.poll() for p in self.procs]
        failed = [c for c in codes
                  if c is not None and c not in (0, RELAUNCH_EXIT_CODE)]
        if failed:
            self.kill()
            self.returncode = failed[0]
        elif all(c is not None for c in codes):
            self.returncode = (RELAUNCH_EXIT_CODE
                               if RELAUNCH_EXIT_CODE in codes else 0)
        return self.returncode

    def wait(self, timeout: float | None = None) -> int:
        """Block until :meth:`poll` has a code (``subprocess.
        TimeoutExpired`` past ``timeout`` seconds)."""
        import subprocess
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(self.procs[0].args, timeout)
            time.sleep(0.05)
        return self.returncode

    def terminate(self) -> None:
        """SIGTERM to every rank still running."""
        for p in self.procs:
            if p.poll() is None:
                p.terminate()

    def kill(self) -> None:
        """SIGKILL to every rank still running, and reap them all."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


def spawn_world(cmd: list[str], n: int, env: dict | None = None,
                **popen_kw) -> World:
    """Start ``n`` copies of ``cmd`` as the ranks of one world, each with
    the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` = localhost and a free ``MASTER_PORT``) over ``env``
    (default: this process's); ``LOCAL_RANK`` wraps over the visible CUDA
    devices, so ranks share a card when there are fewer (they then need
    ``--dist-backend gloo``). ``n = 1`` starts the command alone, with no
    process group. ``popen_kw`` go to every ``subprocess.Popen``."""
    import subprocess
    base = {k: v for k, v in (os.environ if env is None else env).items()
            if k not in RANK_ENV}
    if n <= 1:
        return World([subprocess.Popen(cmd, env=base, **popen_kw)])
    port = free_port()
    cards = torch.cuda.device_count()
    procs = []
    for rank in range(n):
        rank_env = {**base, 'RANK': str(rank), 'WORLD_SIZE': str(n),
                    'LOCAL_RANK': str(rank % cards if cards else rank),
                    'LOCAL_WORLD_SIZE': str(n), 'MASTER_ADDR': 'localhost',
                    'MASTER_PORT': str(port)}
        procs.append(subprocess.Popen(cmd, env=rank_env, **popen_kw))
    return World(procs)
