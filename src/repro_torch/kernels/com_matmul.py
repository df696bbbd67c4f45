"""``com_matmul``: tiled matmul with the fused ROFM epilogue, as a CUDA kernel.

Domino's PE (CIM crossbar MAC) + ROFM inter-memory functions (Tab. II):
the K loop accumulates partial sums in f32 registers (the analogue of
partial sums riding the ROFM plane — never spilled to device memory), and
the epilogue (Add = bias, Act = relu/silu/gelu, Bp = residual) is applied
after the last K step, before the single store.

Counterpart of ``repro.kernels.com_matmul``; the kernel is
``src/repro_torch/csrc/com_matmul.cu``. For a tensor on the CPU the
wrapper runs the plain version (:func:`repro_torch.kernels.ref.com_matmul_ref`);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ACTIVATIONS, com_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, w, bias, residual, out, M, N, K, act, dtype, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(name, t, want_shape, dtype, device):
    if t.shape != want_shape:
        raise ValueError(f"com_matmul: {name} has shape {tuple(t.shape)}, expected {want_shape}")
    if t.dtype != dtype:
        raise TypeError(f"com_matmul: {name} is {t.dtype}, x is {dtype}")
    if t.device != device:
        raise ValueError(f"com_matmul: {name} is on {t.device}, x is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"com_matmul: {name} must be contiguous")


def com_matmul(x: torch.Tensor, w: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, K), w: (K, N) -> (M, N) in ``x.dtype`` (float32 or bfloat16),
    ``act(x @ w + bias) + residual`` with an f32 accumulator."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; expected one of {ACTIVATIONS}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"com_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)} do not chain")
    if x.device.type == "cpu":
        return com_matmul_ref(x, w, bias=bias, activation=activation, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"com_matmul: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"com_matmul: x is {x.dtype}; the kernel takes {list(_DTYPES)}")
    M, K = x.shape
    N = w.shape[1]
    _check("x", x, (M, K), x.dtype, x.device)
    _check("w", w, (K, N), x.dtype, x.device)
    if bias is not None:
        _check("bias", bias, (N,), x.dtype, x.device)
    if residual is not None:
        _check("residual", residual, (M, N), x.dtype, x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    kernel = _build.function("com_matmul", "repro_com_matmul", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = kernel(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), M, N, K, ACTIVATIONS.index(activation), _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"com_matmul kernel launch failed: CUDA error {err}")
    com_matmul.launches += 1
    return out


# kernel launches since the last reset (plain integer; set it to 0 to reset)
com_matmul.launches = 0


def com_matmul_padded(x: torch.Tensor, w: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None) -> torch.Tensor:
    """:func:`com_matmul` for arbitrary (unaligned) shapes — the name the
    JAX package's executor calls. The kernel masks its ragged edges
    itself, so nothing is padded."""
    return com_matmul(x, w, bias=bias, activation=activation)
