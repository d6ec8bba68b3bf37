"""The ImageNet ResNet at a compute ``dtype`` against the JAX model: the checks
of ``tests/test_torch_model_dtype.py`` (forward pass, capture dtypes and
one K-FAC step at fp16 and bf16, with its tolerances), in a file of its own
so that each file stays well inside a minute."""

import pytest
import torch

from test_torch_model_dtype import (
    check_capture_dtypes,
    check_forward,
    check_kfac_step,
)

CASES = [('imagenet_resnet', 'fp16'), ('imagenet_resnet', 'bf16')]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize('family,dname', CASES)
def test_forward_and_loss_match_jax(family, dname):
    check_forward(family, dname)


@pytest.mark.parametrize('family,dname', CASES)
def test_capture_dtypes_match_jax(family, dname):
    check_capture_dtypes(family, dname)


@pytest.mark.parametrize('family,dname', CASES)
def test_kfac_step_matches_jax(family, dname):
    check_kfac_step(family, dname)
