"""Public entry points of the port's kernels.

Counterpart of ``repro.kernels.ops``. ``backend`` selects the path:

* ``None`` (default) — the tensor decides: a CUDA tensor launches the
  CUDA kernel, a CPU tensor takes the plain PyTorch version;
* ``"cuda"`` — the CUDA kernel; raises for a tensor that is not on a
  card, so a run that asked for the kernel never quietly runs without it;
* ``"ref"`` — the plain PyTorch version, on the tensor's own device.

Every Pallas kernel of the JAX package is ported: ``com_matmul``,
``conv2d_com``, ``flash_attention`` and ``slstm_fused`` (``slstm``).
``flash_attention`` and ``slstm`` are differentiable: where grad is enabled
and an input requires it, they run through :class:`FlashAttention` and
:class:`SLSTMFused`, whose backwards are the CUDA backward kernels for CUDA
tensors and the plain backwards for CPU tensors or ``backend="ref"``.

Under a mesh (``DTensor`` inputs, model-parallel training)
``flash_attention`` runs through ``local_map``: each rank's forward and
backward, the CUDA kernels on the card, see its own plain local tensors
``(B_local, S, H_local, hd)`` with ``KVH_local`` heads, and nothing is
gathered for them; the vlm cross layers' the same way, non-causal, with
``Skv`` image keys against ``Sq`` text queries.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.com_matmul import com_matmul as _com_matmul
from repro_torch.kernels.conv2d_com import conv2d_com as _conv2d_com
from repro_torch.kernels.flash_attention import BLOCK_KV
from repro_torch.kernels.flash_attention import flash_attention as _flash_attention
from repro_torch.kernels.flash_attention import flash_attention_bwd as _flash_attention_bwd
from repro_torch.kernels.slstm import slstm_fused as _slstm_fused
from repro_torch.kernels.slstm import slstm_fused_bwd as _slstm_fused_bwd

BACKENDS = ("cuda", "ref")


def _resolve(x, backend):
    if backend is None:
        return "cuda" if x.is_cuda else "ref"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS} or None")
    if backend == "cuda" and not x.is_cuda:
        raise RuntimeError(
            f"backend='cuda' needs a tensor on a CUDA device, got one on {x.device}")
    return backend


def com_matmul(x, w, *, bias=None, activation=None, residual=None, backend=None):
    if _resolve(x, backend) == "ref":
        return _ref.com_matmul_ref(x, w, bias=bias, activation=activation, residual=residual)
    return _com_matmul(x, w, bias=bias, activation=activation, residual=residual)


def conv2d(x, w, *, stride=1, padding=1, activation=None, backend=None):
    if _resolve(x, backend) == "ref":
        return _ref.conv2d_com_ref(x, w, stride=stride, padding=padding, activation=activation)
    return _conv2d_com(x, w, stride=stride, padding=padding, activation=activation)


class FlashAttention(torch.autograd.Function):
    """Attention whose gradient is the reference's blockwise backward
    (``repro.models.attention._flash_vjp_bwd``): the forward saves ``(q, k,
    v, out, lse)``, and the backward recomputes the weights from ``lse``.
    ``path`` is ``"cuda"`` (the kernels, forward and backward) or ``"ref"``
    (the plain versions, on the tensors' own device)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, path, block_kv):
        if path == "ref":
            out, lse = _ref.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
        else:
            out, lse = _flash_attention(q, k, v, causal=causal, block_kv=block_kv,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.path, ctx.block_kv = causal, path, block_kv
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if ctx.path == "ref":
            dq, dk, dv = _ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=ctx.causal)
        else:
            dq, dk, dv = _flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                                              block_kv=ctx.block_kv)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, backend=None, block_kv=BLOCK_KV):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd) -> (B, Sq, H, hd), GQA read
    in place, causal mask top-left aligned. Differentiable through
    :class:`FlashAttention` where grad is enabled and an input requires it;
    otherwise (serving) the forward alone, with no lse written. ``DTensor``
    inputs run on each rank's local rows and heads (:func:`_flash_local`)."""
    if isinstance(q, DTensor):
        return _flash_local(q, k, v, causal=causal, backend=backend, block_kv=block_kv)
    path = _resolve(q, backend)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), path, block_kv)
    if path == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal)
    return _flash_attention(q, k, v, causal=causal, block_kv=block_kv)


def _flash_local(q, k, v, *, causal, backend, block_kv):
    """:func:`flash_attention` of ``DTensor`` q, k, v laid out alike over
    every mesh axis (batch or heads split, or replicated; never the
    sequence, never a partial sum), each rank on its local tensors; the
    output is laid out as q."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    if not (q.placements == k.placements == v.placements):
        raise ValueError(f"q, k and v must be laid out alike: {q.placements}, {k.placements}, "
                         f"{v.placements}")
    if any(not (p.is_replicate() or (isinstance(p, Shard) and p.dim in (0, 2)))
           for p in q.placements):
        raise ValueError(f"attention splits the batch or the heads only, not {q.placements}")
    return local_map(lambda a, b, c: flash_attention(a, b, c, causal=causal, backend=backend,
                                                     block_kv=block_kv),
                     out_placements=list(q.placements), in_placements=(list(q.placements),) * 3,
                     device_mesh=q.device_mesh)(q, k, v)


class SLSTMFused(torch.autograd.Function):
    """The sLSTM recurrence whose gradient is the reverse recurrence
    (:func:`repro_torch.kernels.ref.slstm_bwd_ref`; the reference
    differentiates its ``lax.scan``): the forward saves its per-step state
    and ``rg``, the backward returns ``(dgx, dR)``. Returns ``h`` and the
    final ``(c, n, h, m)``, the state marked non-differentiable (training
    does not read it). ``path`` is ``"cuda"`` (the kernels, forward and
    backward) or ``"ref"`` (the plain versions, on the tensors' own device)."""

    @staticmethod
    def forward(ctx, gx, rg, num_heads, path):
        fwd = _ref.slstm_ref if path == "ref" else _slstm_fused
        h, state, saved = fwd(gx, rg, num_heads, save=True)
        ctx.save_for_backward(rg, saved)
        ctx.num_heads, ctx.path = num_heads, path
        ctx.mark_non_differentiable(*state)
        return (h, *state)

    @staticmethod
    def backward(ctx, dh, *_):
        rg, saved = ctx.saved_tensors
        bwd = _ref.slstm_bwd_ref if ctx.path == "ref" else _slstm_fused_bwd
        dgx, dr = bwd(rg, saved, dh.contiguous(), ctx.num_heads)
        return dgx, dr, None, None


def slstm(gx, rg, num_heads, *, backend=None):
    """gx: (B, S, 4, D) gate pre-activations; rg: (4, H, hd, hd) -> h (B, S, D)
    in ``gx.dtype`` and the final float32 state ``(c, n, h, m)``, each
    (B, H, hd). Differentiable through :class:`SLSTMFused` where grad is
    enabled and ``gx`` or ``rg`` requires it; otherwise (serving) the forward
    alone, with no per-step state written."""
    path = _resolve(gx, backend)
    if torch.is_grad_enabled() and (gx.requires_grad or rg.requires_grad):
        h, *state = SLSTMFused.apply(gx, rg, num_heads, path)
        return h, tuple(state)
    if path == "ref":
        return _ref.slstm_ref(gx, rg, num_heads)
    return _slstm_fused(gx, rg, num_heads)
