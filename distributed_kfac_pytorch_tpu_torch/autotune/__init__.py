"""Closed-loop perf autotuner over the observability stack (PyTorch port
of ``distributed_kfac_pytorch_tpu/autotune``).

Probe candidate knob settings through short warm segments of the real
engine (:mod:`autotune.probe`), score them on the gate metrics
(:mod:`autotune.score`), commit the winner as a per-workload
``TUNED_<workload>.json`` artifact (:mod:`autotune.driver`) the CLIs load
fail-closed via ``--tuned-config`` (:mod:`autotune.cli`), plus the first
dynamic in-run policy, the straggler-aware cadence backoff
(:mod:`autotune.policy`, ``--cadence-backoff``).

    python -m distributed_kfac_pytorch_tpu_torch.autotune \\
        --workload cifar_resnet20
"""

from distributed_kfac_pytorch_tpu_torch.autotune import cli  # noqa: F401
from distributed_kfac_pytorch_tpu_torch.autotune import space  # noqa: F401
from distributed_kfac_pytorch_tpu_torch.autotune.driver import (  # noqa: F401
    ARTIFACT_FORMAT,
    apply_tuned,
    emit_events,
    kfac_overrides,
    live_world,
    load_tuned_config,
    platform_of,
    read_tuned,
    tune,
    tuned_path,
    write_tuned,
)
from distributed_kfac_pytorch_tpu_torch.autotune.policy import (  # noqa: F401
    BackoffConfig,
    StragglerCadencePolicy,
)
from distributed_kfac_pytorch_tpu_torch.autotune.probe import (  # noqa: F401
    WORKLOADS,
    ProbeResult,
    Workload,
    get_workload,
    probe_candidate,
)
from distributed_kfac_pytorch_tpu_torch.autotune.score import (  # noqa: F401
    hard_violation,
    objective_value,
    rank_candidates,
    scores_close,
)
