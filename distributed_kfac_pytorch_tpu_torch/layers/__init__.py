"""Layer-kind dispatch for the K-FAC factor math."""

from distributed_kfac_pytorch_tpu_torch.layers.base import (  # noqa: F401
    compute_a_factor,
    compute_g_factor,
    factor_shapes,
    grads_to_matrix,
    matrix_to_grads,
)
