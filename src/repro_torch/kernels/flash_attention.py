"""``flash_attention``: online-softmax (flash) attention forward, as a CUDA
kernel.

Scores never reach device memory: each block keeps its running max, sum
and f32 accumulator on chip while it walks the KV tiles, the attention
analogue of COM partial sums staying on the ROFM plane. GQA is read in
place: query head ``h`` reads KV head ``h // (H / KVH)``.

Counterpart of ``repro.kernels.flash_attention`` (``flash_attention`` and
``flash_attention_gqa``); the kernel is
``src/repro_torch/csrc/flash_attention.cu``. For a tensor on the CPU the
wrapper runs the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)  # the head sizes the kernel is instantiated for
BLOCK_KV = 64  # the kernel's KV tile
# q, k, v, out, B, Sq, Skv, H, KVH, hd, causal, scale, dtype, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    block_kv: int = BLOCK_KV) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd) -> (B, Sq, H, hd) in
    ``q.dtype`` (float32 or bfloat16 on the card). The causal mask is
    top-left aligned (``k_pos <= q_pos``). ``block_kv`` names the kernel's
    KV tile, which is built as ``BLOCK_KV`` only; the plain version has none."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} are not (B, Sq, H, hd) and (B, Skv, KVH, hd)")
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KVH < 1 or H % KVH:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not serve q {tuple(q.shape)}")
    if Sq < 1 or Skv < 1:
        raise ValueError(f"flash_attention: empty sequence (Sq={Sq}, Skv={Skv})")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd}; the kernel is built for {HEAD_DIMS}")
    if block_kv != BLOCK_KV:
        raise ValueError(f"flash_attention: block_kv {block_kv}; the kernel is built for {BLOCK_KV}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}; the "
                        f"kernel takes one of {list(_DTYPES)} for all three")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v are on {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: B={B} or H={H} exceeds the grid's 65535")
    out = torch.empty_like(q)
    kernel = _build.function("flash_attention", "repro_flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv, H, KVH, hd,
            int(bool(causal)), 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


# kernel launches since the last reset (plain integer; set it to 0 to reset)
flash_attention.launches = 0
