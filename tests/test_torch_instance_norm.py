"""The port's InstanceNorm (tpumil_torch/ops/instance_norm.py) against the
JAX package: the Pallas kernel in interpret mode and the XLA norm
resnet._norm, on the same numpy inputs.

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel
itself is held against that plain version on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumil.models import resnet as jresnet
from tpumil.ops.in_pallas import fused_instance_norm as jax_fused_in
from tpumil_torch.ops.instance_norm import (SLICE_MAX, fused_instance_norm,
                                            instance_norm_plain,
                                            plan_instance_norm)
from tpumil_torch.utils import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32: the same statistics summed in another order (test_in_pallas.py's bar)
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16: outputs rounded to bf16 may differ by one bf16 step (2^-7 relative)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-2)


def _jax_norm(x: np.ndarray, relu: bool) -> np.ndarray:
    cfg = jresnet.ResNetConfig(depth=18, norm="instance")
    y = jresnet._norm({}, jnp.asarray(x), "conv1.weight", cfg)
    y = jnp.maximum(y, 0) if relu else y
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(4, 8, 8, 64), (4, 4, 4, 128),
                                   (2, 4, 4, 256), (8, 2, 2, 512),
                                   (3, 5, 2, 64)])
def test_plain_matches_pallas_and_xla(shape, relu, rng):
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    got = instance_norm_plain(torch.from_numpy(x), relu).numpy()
    pallas = np.asarray(jax_fused_in(jnp.asarray(x), relu=relu,
                                     interpret=True))
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    np.testing.assert_allclose(got, _jax_norm(x, relu), **F32_TOL)
    # the wrapper takes the plain version for a CPU tensor, bit for bit
    wrapped = fused_instance_norm(torch.from_numpy(x), relu).numpy()
    np.testing.assert_array_equal(wrapped, got)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 4, 4, 256)])
def test_bf16_matches_xla_bf16(shape, rng):
    """bf16 activations, f32 statistics over the stored bf16 values."""
    x32 = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    xb = torch.from_numpy(x32).to(torch.bfloat16)
    got = fused_instance_norm(xb, relu=True)
    assert got.dtype == torch.bfloat16
    # the same bf16 values on the JAX side
    want = _jax_norm(np.asarray(jnp.asarray(xb.float().numpy())
                                .astype(jnp.bfloat16)), relu=True)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_constant_planes_give_no_nan(rng):
    """A blank tile's plane has variance 0: the output is finite and
    matches the two-pass XLA norm (test_in_pallas.py's bar). The CUDA
    kernel's shifted sums give exact zeros there (checked on the card)."""
    x = np.full((2, 8, 8, 64), 3.7, np.float32)
    x[1] += rng.standard_normal((8, 8, 64)).astype(np.float32) * 1e-4
    got = fused_instance_norm(torch.from_numpy(x), relu=False).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got[0]).max() < 1e-3
    np.testing.assert_allclose(got, _jax_norm(x, False), atol=2e-2)


@pytest.mark.parametrize("bad,match", [
    (lambda: torch.zeros(2, 4, 64), "rank-4"),
    (lambda: torch.zeros(2, 4, 4, 4, 64), "rank-4"),
    (lambda: torch.zeros(2, 4, 4, 64, dtype=torch.float16), "dtype"),
    (lambda: torch.zeros(2, 4, 4, 64, dtype=torch.float64), "dtype"),
    (lambda: torch.zeros(2, 4, 4, 64, dtype=torch.int32), "dtype"),
    # an NCHW channels_last tensor must come as its NHWC permute
    (lambda: torch.zeros(2, 64, 4, 4).to(memory_format=torch.channels_last),
     "NHWC-contiguous"),
    # a plain NCHW tensor permuted to NHWC is not NHWC memory
    (lambda: torch.zeros(2, 64, 4, 4).permute(0, 2, 3, 1), "NHWC-contiguous"),
    (lambda: torch.zeros(2, 4, 8, 64)[:, :, ::2], "NHWC-contiguous"),
])
def test_wrapper_rejects_bad_input(bad, match):
    with pytest.raises(ValueError, match=match):
        fused_instance_norm(bad())


def test_channels_last_view_is_accepted(rng):
    """The layout the port's ResNet runs in: NCHW channels_last, handed
    over as its NHWC permute (same memory, no copy)."""
    x = torch.from_numpy(rng.standard_normal((2, 64, 6, 6)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    nhwc = x.permute(0, 2, 3, 1)
    assert nhwc.data_ptr() == x.data_ptr() and nhwc.is_contiguous()
    got = fused_instance_norm(nhwc, relu=True).permute(0, 3, 1, 2)
    want = torch.relu(torch.nn.functional.instance_norm(x, eps=1e-5))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_cpu_path_launches_nothing(rng):
    fused_instance_norm.launches = 0
    x = torch.from_numpy(rng.standard_normal((2, 4, 4, 64)).astype(np.float32))
    fused_instance_norm(x, relu=True)
    assert fused_instance_norm.launches == 0


def test_import_and_cpu_use_need_no_nvcc(tmp_path):
    """Importing the kernel modules, and running them on CPU tensors, never
    builds or loads the CUDA library (there is no nvcc here)."""
    code = (
        "import torch\n"
        "from tpumil_torch.ops.instance_norm import fused_instance_norm\n"
        "from tpumil_torch.models import resnet, embedder\n"
        "from tpumil_torch.utils import build\n"
        "fused_instance_norm(torch.ones(1, 2, 2, 8))\n"
        "assert build._lib is None and fused_instance_norm.launches == 0\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_build_is_keyed_by_source_contents(tmp_path, monkeypatch):
    """The library name hashes the sources and the headers beside them: an
    edit to either means a rebuild; no nvcc means a clear error, not a
    silent fallback."""
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    h1 = build._source_hash([src])
    assert build._source_hash([src]) == h1
    src.write_text("// v2\n")
    assert build._source_hash([src]) != h1
    # a header beside the sources is hashed too, though never compiled alone
    hdr = tmp_path / "k.cuh"
    hdr.write_text("// h1\n")
    h2 = build._source_hash([src])
    assert h2 != h1
    hdr.write_text("// h2\n")
    assert build._source_hash([src]) != h2
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
    assert [p.name for p in build.sources()] == [
        "attention_pool.cu", "attention_pool_bf16.cu", "instance_norm.cu",
        "stem.cu"]


def test_other_device_raises_not_falls_back():
    """No code path on a non-CPU device falls back to the plain version."""
    x = torch.zeros(1, 2, 2, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_instance_norm(x)



# every IN site of a ResNet18-IN forward at 224^2 (the 112^2 stem plane is
# K5's): (H = W, C) -> the cluster size the one-read route takes
RESNET18_SITES = {torch.float32: {(56, 64): 4, (28, 128): 1, (14, 256): 1,
                                  (7, 512): 1},
                  torch.bfloat16: {(56, 64): 2, (28, 128): 1, (14, 256): 1,
                                   (7, 512): 1}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c", [(56, 64), (28, 128), (14, 256), (7, 512)])
def test_planner_sends_resnet18_sites_to_one_read(dtype, hw, c):
    """One read of device memory at every 224^2 site, whole 256-byte rows
    (64 f32 or 128 bf16 channels, or all C when fewer), the plane spread
    over the smallest cluster whose slices fit one CTA's shared memory."""
    plan = plan_instance_norm((128, hw, hw, c), dtype)
    elt = torch.empty((), dtype=dtype).element_size()
    assert plan.route == "one_read"
    assert plan.cluster == RESNET18_SITES[dtype][(hw, c)]
    assert plan.cblock == min(c, 256 // elt)
    assert -(-hw * hw // plan.cluster) * plan.cblock * elt <= SLICE_MAX
    if plan.cluster > 1:  # no smaller cluster would do
        half = -(-hw * hw // (plan.cluster // 2))
        assert half * plan.cblock * elt > SLICE_MAX


@pytest.mark.parametrize("shape,dtype", [
    ((128, 112, 112, 64), torch.float32),    # the stem plane, were it IN's
    ((128, 128, 128, 64), torch.float32),    # the stem at a 256^2 input
    ((128, 128, 128, 64), torch.bfloat16),
])
def test_planner_sends_oversized_planes_to_two_reads(shape, dtype):
    plan = plan_instance_norm(shape, dtype)
    assert plan.route == "two_read" and plan.cluster == 0


def test_planner_plans_fit_for_any_shape(rng):
    """Every one-read plan fits a CTA and a cluster of at most 8; the batch
    size never changes the plan."""
    for _ in range(200):
        h, w = rng.integers(1, 200, size=2)
        c = int(rng.integers(1, 1100))
        for dtype in (torch.float32, torch.bfloat16):
            plan = plan_instance_norm((1, h, w, c), dtype)
            assert plan == plan_instance_norm((64, h, w, c), dtype)
            if plan.route == "two_read":
                continue
            elt = torch.empty((), dtype=dtype).element_size()
            assert plan.cluster in (1, 2, 4, 8)
            assert 1 <= plan.cblock <= c
            assert -(-h * w // plan.cluster) * plan.cblock * elt <= SLICE_MAX
