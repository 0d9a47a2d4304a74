"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on a card of capability (9, 0). Every test skips without one.

This file imports neither jax nor tpumil, so it also runs on a machine
without JAX; there, skip tests/conftest.py (which imports JAX):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpumil_torch.ops.instance_norm import (fused_instance_norm,
                                            instance_norm_plain)

# f32: the same statistics summed in another order; bf16: outputs rounded to
# bf16 may differ by one bf16 step (2^-7 relative)
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-2)}


@pytest.fixture
def card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0)):
        pytest.skip("needs a CUDA card of capability (9, 0)")
    return torch.device("cuda")


def _check(x, relu, tol):
    before = fused_instance_norm.launches
    got = fused_instance_norm(x, relu)
    torch.cuda.synchronize()
    assert fused_instance_norm.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    want = instance_norm_plain(x, relu)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 28, 28, 64), (4, 14, 14, 256),
                                   (2, 7, 7, 512), (3, 5, 2, 96),
                                   (2, 3, 3, 3), (1, 1, 1, 8)])
def test_instance_norm_kernel_matches_plain(card, dtype, shape):
    """Vector loads (C a multiple of 16 bytes) and the scalar path (C=3),
    planes from 1 to 784 rows."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(shape) * 3 + 1)
                         .astype(np.float32)).to(card, dtype)
    for relu in (False, True):
        _check(x, relu, TOL[dtype])


@pytest.mark.cuda
def test_instance_norm_kernel_misaligned_and_constant(card):
    """A contiguous tensor whose data is not 16-byte aligned takes the
    scalar path; an exactly constant plane gives exact zeros."""
    n, h, w, c = 2, 6, 6, 64
    base = torch.randn(n * h * w * c + 1, device=card)
    x = base[1:].view(n, h, w, c)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _check(x, True, TOL[torch.float32])
    const = torch.full((2, 8, 8, 64), 3.7, device=card)
    out = fused_instance_norm(const)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
def test_instance_norm_kernel_rejects_bad_cuda_input(card):
    with pytest.raises(ValueError, match="dtype"):
        fused_instance_norm(torch.zeros(2, 4, 4, 64, device=card,
                                        dtype=torch.float16))
    x = torch.zeros(2, 64, 4, 4, device=card)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        fused_instance_norm(x.permute(0, 2, 3, 1))
