"""Shared checks for the PyTorch port's parity tests (tests/test_torch_*.py):
the same numpy inputs go through the JAX reference and the port, and the
outputs are compared here as numpy arrays."""
import numpy as np
import pytest
import torch


def to_np(x):
    """torch tensor or jax array -> numpy (float32 for bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_within_one_step(fq, fqr, scale, group):
    """The reference kernel bar (tests/test_kernels.py
    ``_assert_within_one_step``): reduction-order ULP differences in the
    scale can flip a round-half boundary — at most ONE quantization step,
    on < 0.1 % of elements."""
    fq = to_np(fq).astype(np.float32)
    fqr = to_np(fqr).astype(np.float32)
    step = np.repeat(to_np(scale), group, axis=0)
    diff = np.abs(fq - fqr)
    assert np.all(diff <= step * 1.001 + 1e-6), "differs by more than one step"
    frac = float(np.mean(diff > step * 0.5))
    assert frac < 1e-3, f"{frac:.2%} of elements off by a step (expected ~0)"


def needs_cuda():
    """Skip the calling test unless a CUDA card is present (decided at run
    time, never at import, so every pytest worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=False)
def one_torch_thread():
    """Run a module's tests on one intra-op thread and restore the count
    after: at the tiny test shapes, PyTorch's CPU thread pool costs far
    more than the work (a 4 x 16 x 256 matmul takes ~100x longer on 8
    threads in a loaded container)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
