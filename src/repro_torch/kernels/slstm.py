"""``slstm_fused``: the sLSTM recurrence of xLSTM, as a CUDA kernel.

One block owns one (batch row, head) for the whole sequence; the cell state
stays on chip and only the gate pre-activations in and ``h`` out cross
device memory, the recurrence's analogue of COM partial sums staying on
the ROFM plane. The input-side projection ``gx = x @ wg + bg`` stays outside
the kernel, as in the reference.

Counterpart of ``repro.kernels.slstm`` (``slstm_fused`` and
``hbm_traffic_model``); the kernel is ``src/repro_torch/csrc/slstm.cu``.
Unlike the Pallas kernel it also returns the final ``(c, n, h, m)`` state,
which a prefill writes into the model's cache, and it takes any ``S >= 1``.
For a tensor on the CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.slstm_ref`); for a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import slstm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 1024  # one thread a hidden unit
# gx, R, h_out, c, n, h, m, B, S, H, hd, dtype, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def slstm_fused(gx: torch.Tensor, rg: torch.Tensor, num_heads: int
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """gx: ``(B, S, 4, D)`` gate pre-activations (float32 or bfloat16 on
    the card); rg: ``(4, H, hd, hd)`` float32 recurrent weights. Returns
    ``h`` ``(B, S, D)`` in ``gx.dtype`` and the final state ``(c, n, h, m)``,
    each float32 ``(B, H, hd)``."""
    if gx.dim() != 4 or gx.shape[2] != 4:
        raise ValueError(f"slstm_fused: gx {tuple(gx.shape)} is not (B, S, 4, D)")
    B, S, _, D = gx.shape
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"slstm_fused: D={D} does not split into {num_heads} heads")
    hd = D // num_heads
    if tuple(rg.shape) != (4, num_heads, hd, hd):
        raise ValueError(f"slstm_fused: rg {tuple(rg.shape)} is not "
                         f"{(4, num_heads, hd, hd)} for gx {tuple(gx.shape)}")
    if B < 1 or S < 1:
        raise ValueError(f"slstm_fused: empty batch or sequence (B={B}, S={S})")
    if gx.device.type == "cpu":
        return slstm_ref(gx, rg, num_heads)
    if gx.device.type != "cuda":
        raise ValueError(f"slstm_fused: no kernel for device {gx.device}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"slstm_fused: head_dim {hd} > {MAX_HEAD_DIM}")
    if gx.dtype not in _DTYPES or rg.dtype != torch.float32:
        raise TypeError(f"slstm_fused: gx is {gx.dtype} and rg {rg.dtype}; the kernel takes "
                        f"gx in one of {list(_DTYPES)} and rg in torch.float32")
    if rg.device != gx.device:
        raise ValueError(f"slstm_fused: gx is on {gx.device}, rg on {rg.device}")
    if not (gx.is_contiguous() and rg.is_contiguous()):
        raise ValueError("slstm_fused: gx and rg must be contiguous")
    if B > 65535:
        raise ValueError(f"slstm_fused: B={B} exceeds the grid's 65535")
    h_out = torch.empty((B, S, D), dtype=gx.dtype, device=gx.device)
    state = tuple(torch.empty((B, num_heads, hd), dtype=torch.float32, device=gx.device)
                  for _ in range(4))
    kernel = _build.function("slstm", "repro_slstm", _ARGTYPES)
    with torch.cuda.device(gx.device):
        err = kernel(gx.data_ptr(), rg.data_ptr(), h_out.data_ptr(),
                     *(t.data_ptr() for t in state), B, S, num_heads, hd, _DTYPES[gx.dtype],
                     torch.cuda.current_stream(gx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slstm_fused kernel launch failed: CUDA error {err}")
    slstm_fused.launches += 1
    return h_out, state


# kernel launches since the last reset (plain integer; set it to 0 to reset)
slstm_fused.launches = 0


def hbm_traffic_model(B, S, D, num_heads, dtype_bytes=2):
    """Analytic HBM bytes per layer per sequence: baseline scan vs fused."""
    hd = D // num_heads
    r_bytes = 4 * num_heads * hd * hd * 4
    state_bytes = 4 * num_heads * hd * B * 4
    baseline = S * (r_bytes + 2 * state_bytes + 4 * D * B * dtype_bytes)
    fused = B * S * 4 * D * dtype_bytes + B * S * D * dtype_bytes + r_bytes
    return {"baseline_bytes": baseline, "fused_bytes": fused,
            "reduction_x": baseline / fused}
