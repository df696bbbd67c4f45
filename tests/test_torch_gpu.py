"""The port's CUDA kernels and its ``"cuda"`` executor backend on the card.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where there is no card (the fixture decides, never the import). This
file imports nothing of JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same inputs,
within 2e-5 (float32) or 2e-2 (bfloat16) of the plain result's largest
magnitude (tests/test_kernels.py:18-19); the executor's logits are held
against its float64 reference backend within 2e-5 · max|ref|
(tests/test_executor.py:87). TF32 is off in the plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.arch import DEFAULT_ARCH
from repro_torch.core.executor import random_weights
from repro_torch.core.mapping import ConvSpec, FCSpec, vgg11_cifar
from repro_torch.core.program import Workload, compile_program
from repro_torch.kernels import ops, ref
from repro_torch.kernels.com_matmul import com_matmul
from repro_torch.kernels.conv2d_com import conv2d_com

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run: "
                    "python -m pytest -m gpu tests/test_torch_gpu.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _within(got, want, dtype):
    scale = want.double().abs().max().item()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    err = (got.double() - want.double()).abs().max().item()
    assert torch.isfinite(got).all() and err <= tol * scale, (err, tol, scale)


# one shape for each tile the kernel picks: skinny M, N <= 64, the full tile
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 300, 100), (100, 70, 50), (257, 129, 130)])
def test_com_matmul_kernel_matches_plain_version(cuda, m, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x, w, b, r = (torch.randn(s, generator=gen, device=cuda).to(dtype)
                  for s in ((m, k), (k, n), (n,), (m, n)))
    for act in (None, "relu", "silu", "gelu"):
        for kw in (dict(), dict(bias=b, residual=r)):
            launches = com_matmul.launches
            got = com_matmul(x, w, activation=act, **kw)
            torch.cuda.synchronize()
            assert com_matmul.launches == launches + 1
            assert got.dtype == dtype and tuple(got.shape) == (m, n)
            _within(got, ref.com_matmul_ref(x, w, activation=act, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,m,k,s,p", [(16, 10, 3, 8, 3, 1, 1), (12, 12, 20, 70, 5, 2, 2),
                                           (9, 13, 8, 64, 1, 1, 0)])
def test_conv2d_com_kernel_matches_plain_version(cuda, h, w, c, m, k, s, p, dtype):
    gen = torch.Generator(device=cuda).manual_seed(h * w + c)
    x = torch.randn((h, w, c), generator=gen, device=cuda).to(dtype)
    wt = torch.randn((k, k, c, m), generator=gen, device=cuda).to(dtype)
    for act in (None, "relu"):
        launches = conv2d_com.launches
        got = conv2d_com(x, wt, stride=s, padding=p, activation=act)
        torch.cuda.synchronize()
        assert conv2d_com.launches == launches + 1
        _within(got, ref.conv2d_com_ref(x, wt, stride=s, padding=p, activation=act), dtype)


def test_ops_route_cuda_tensors_to_the_kernels(cuda):
    x, w = torch.randn((64, 32), device=cuda), torch.randn((32, 16), device=cuda)
    img, wc = torch.randn((8, 8, 4), device=cuda), torch.randn((3, 3, 4, 8), device=cuda)
    before = (com_matmul.launches, conv2d_com.launches)
    ops.com_matmul(x, w)
    ops.conv2d(img, wc, backend="cuda")
    assert (com_matmul.launches, conv2d_com.launches) == (before[0] + 1, before[1] + 1)
    ops.com_matmul(x, w, backend="ref")
    ops.conv2d(img, wc, backend="ref")
    assert (com_matmul.launches, conv2d_com.launches) == (before[0] + 1, before[1] + 1)


def test_kernel_wrappers_check_layout_and_types(cuda):
    x = torch.ones((8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        com_matmul(x.t(), torch.ones((8, 4), device=cuda))
    with pytest.raises(TypeError):
        com_matmul(x, torch.ones((8, 4), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        com_matmul(x.double(), torch.ones((8, 4), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        conv2d_com(torch.ones((4, 6, 2), device=cuda).transpose(0, 1),
                   torch.ones((3, 3, 2, 2), device=cuda))


def _programs():
    small = Workload("mb", (ConvSpec("c0", 3, 3, 12, 8, 8, pool_k=2),
                            ConvSpec("c1", 3, 12, 10, 4, 4),
                            FCSpec("f0", 160, 20), FCSpec("f1", 20, 5)))
    return [(compile_program(vgg11_cifar()), (2, 32, 32, 3)),
            (compile_program(small, DEFAULT_ARCH.replace(n_c=8, n_m=8)), (3, 8, 8, 3))]


@pytest.mark.parametrize("case", [0, 1], ids=["vgg11-cifar", "multiblock"])
def test_cuda_executor_matches_reference_on_the_card(cuda, case):
    program, shape = _programs()[case]
    weights = random_weights(program, seed=1)
    images = np.random.default_rng(0).normal(size=shape)
    want = program.execute(images, weights, backend="reference", device=cuda)
    com_matmul.launches = 0
    res = program.execute(images, weights)
    assert com_matmul.launches == len(program.layer_programs)
    assert res.outputs.device.type == "cuda" and res.outputs.dtype == torch.float32
    _within(res.outputs, want.outputs, torch.float32)
    assert res.events == dict(program.event_totals) == want.events
