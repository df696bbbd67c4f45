"""``conv2d_com``: direct convolution WITHOUT im2col (paper §III-B), as a
CUDA kernel.

Domino's central dataflow claim: convolution as K² kernel-position partial
sums accumulated on the move — the Toeplitz/im2col matrix is never
materialized. The kernel holds an input halo tile in shared memory and
re-slices it for every kernel position (the RIFM's in-buffer shift), the
partial sums of the K² shifted products accumulating in f32 registers with
one store and a fused activation at the end.

Counterpart of ``repro.kernels.conv2d_com``; the kernel is
``src/repro_torch/csrc/conv2d_com.cu``. For a tensor on the CPU the
wrapper runs the plain version (:func:`repro_torch.kernels.ref.conv2d_com_ref`);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import conv2d_com_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, w, out, H, W, C, K, M, stride, pad, H_out, W_out, relu, dtype, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def conv2d_com(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, padding: int = 1,
               activation: Optional[str] = None) -> torch.Tensor:
    """x: (H, W, C); w: (K, K, C, M) -> (H_out, W_out, M) in ``x.dtype``
    (float32 or bfloat16). ``activation`` is ``"relu"`` or ``None``."""
    if activation not in (None, "relu"):
        raise ValueError(f"conv2d_com: activation {activation!r}; expected 'relu' or None")
    if x.dim() != 3 or w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != x.shape[2]:
        raise ValueError(
            f"conv2d_com: x {tuple(x.shape)} and w {tuple(w.shape)} are not (H, W, C) "
            "and (K, K, C, M)")
    H, W, C = x.shape
    K, M = w.shape[0], w.shape[3]
    if stride < 1 or padding < 0:
        raise ValueError(f"conv2d_com: stride {stride} and padding {padding}")
    H_out = (H + 2 * padding - K) // stride + 1
    W_out = (W + 2 * padding - K) // stride + 1
    if H_out < 1 or W_out < 1:
        raise ValueError(f"conv2d_com: a {K}x{K} kernel does not fit a padded {H}x{W} image")
    if x.device.type == "cpu":
        return conv2d_com_ref(x, w, stride=stride, padding=padding, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_com: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv2d_com: x is {x.dtype}, w is {w.dtype}; the kernel takes "
                        f"one of {list(_DTYPES)} for both")
    if w.device != x.device:
        raise ValueError(f"conv2d_com: w is on {w.device}, x is on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_com: x and w must be contiguous")
    out = torch.empty((H_out, W_out, M), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    kernel = _build.function("conv2d_com", "repro_conv2d_com", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = kernel(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), H, W, C, K, M, stride, padding,
            H_out, W_out, int(activation == "relu"), _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv2d_com kernel launch failed: CUDA error {err}")
    conv2d_com.launches += 1
    return out


# kernel launches since the last reset (plain integer; set it to 0 to reset)
conv2d_com.launches = 0
