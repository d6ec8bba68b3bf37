"""Layer-kind dispatch for the K-FAC factor math."""

from distributed_kfac_pytorch_tpu_torch.layers.base import (  # noqa: F401
    GRAD_QUADRATIC_KEYS,
    compute_a_factor,
    compute_g_factor,
    compute_tied_factor_extras,
    factor_shapes,
    grads_to_matrix,
    matrix_to_grads,
)
