"""distributed_kfac_pytorch_tpu_torch: the PyTorch / CUDA port of
``distributed_kfac_pytorch_tpu``.

Single-device K-FAC for convolutional and dense layers, with hand-written
Hopper kernels for the factor contraction + EMA, the conv-A patch
covariance and the bucketed preconditioning (``ops.kernels``). The JAX
package stays the reference; this package imports nothing of it.

Every entry point takes ``device=`` (default ``'cuda'``) and raises when
no CUDA device is present unless the CPU is asked for explicitly. Entry
points also turn TF32 off for matmuls and convolutions, so fp32 work runs
in full fp32 as the JAX reference's ``Precision.HIGHEST`` paths do.
"""

from __future__ import annotations

import torch

__version__ = '0.1.0'


def resolve_device(device='cuda') -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``'cuda'`` (the default) requires a CUDA device and raises without
    one; the CPU runs only when asked for (``device='cpu'``).
    """
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device={device!r} requested but no CUDA device is available; '
            "pass device='cpu' to run on the CPU")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {device!r}')
    return dev


def set_fp32_precision() -> None:
    """Full-fp32 matmuls and convolutions: TF32 off for both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def __getattr__(name):
    # Lazy so that importing the package (and ops.kernels alone) stays
    # cheap; ``from distributed_kfac_pytorch_tpu_torch import KFAC`` works.
    if name == 'KFAC':
        from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
        return KFAC
    raise AttributeError(name)


__all__ = ['KFAC', 'resolve_device', 'set_fp32_precision']
