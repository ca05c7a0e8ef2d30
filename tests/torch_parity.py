"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy inputs go through the JAX package and its PyTorch
counterpart on the CPU. JAX runs f32 at 'highest' matmul precision
(tests/conftest.py); the port's CPU matmuls are plain f32.
"""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs under several xdist workers: keep torch's CPU threads
    from starving the JAX tests."""
    torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """Card-only tests: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run `pytest -m gpu tests/` on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def t(x, dtype=torch.float32) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def n(x) -> np.ndarray:
    """torch tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cameras_from_jax(cams):
    """JAX Cameras -> the port's Cameras with identical tensors."""
    from geosplatting_tpu_torch.graphics.cameras import Cameras

    return Cameras(
        c2w=t(cams.c2w), fx=t(cams.fx), fy=t(cams.fy), cx=t(cams.cx), cy=t(cams.cy),
        width=cams.width, height=cams.height, near=cams.near, far=cams.far,
    )
