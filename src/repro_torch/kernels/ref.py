"""Plain PyTorch versions of the port's kernels (the allclose targets).

Counterparts of ``repro.kernels.ref``: the same arithmetic, in float32,
on whatever device the tensors live on. Each kernel wrapper runs these for
a tensor on the CPU, and the tests and ``chip_smoke.py`` hold the CUDA
kernels against them on the card. GELU is the tanh form, as
``jax.nn.gelu`` is by default.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

ACTIVATIONS = (None, "relu", "silu", "gelu")


def _epilogue(y, bias, activation, residual):
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; expected one of {ACTIVATIONS}")
    if bias is not None:
        y = y + bias
    if activation == "relu":
        y = F.relu(y)
    elif activation == "silu":
        y = F.silu(y)
    elif activation == "gelu":
        y = F.gelu(y, approximate="tanh")
    if residual is not None:
        y = y + residual
    return y


def com_matmul_ref(x: torch.Tensor, w: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M,K) @ (K,N) + fused ROFM epilogue (Add/Act/Bp), f32 accumulation,
    one cast back to ``x.dtype``."""
    y = x.float() @ w.float()
    y = _epilogue(y, None if bias is None else bias.float(), activation,
                  None if residual is None else residual.float())
    return y.to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, return_lse: bool = False):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd) -> (B, Sq, H, hd) in
    ``q.dtype``: softmax attention in float32, query head ``h`` reading KV
    head ``h // (H / KVH)``.

    q is cast to float32 and then scaled by ``1/sqrt(hd)``, as the Pallas
    kernel does (``repro/kernels/flash_attention.py:39``). The causal mask is
    top-left aligned, ``k_pos <= q_pos``, as the Pallas kernel and the
    model's blockwise attention mask it; for ``Sq == Skv`` that is the usual
    causal mask.

    With ``return_lse``, also each row's log-sum-exp of the scaled scores,
    float32 ``(B, H, Sq)`` (the layout the CUDA kernel writes), natural log:
    ``max(m, -1e30) + log(max(l, 1e-30))`` for the row max ``m`` and ``l =
    sum(exp(s - m))``, as ``repro/models/attention.py:145`` defines it. The
    output is the same either way.
    """
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    out = out.reshape(B, Sq, H, hd).to(q.dtype)
    if not return_lse:
        return out
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    lse = m.clamp(min=-1e30) + torch.log(l.clamp(min=1e-30))
    return out, lse.reshape(B, H, Sq)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """The float32 scaled scores ``(B, KVH, G, Sq, Skv)``, masked to -inf
    above the top-left diagonal when ``causal``."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, KVH, H // KVH, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
    return s


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`flash_attention_ref`: ``(dq, dk, dv)`` from the
    forward's inputs, its output, its ``lse`` (float32 ``(B, H, Sq)``) and
    the output's gradient ``dout``, each cast to its input's dtype.

    The formula of the model attention's ``custom_vjp`` backward
    (``repro/models/attention.py:159-200``) on the full float32 scores:
    ``delta = sum(dout * out)``, ``p = exp(s - lse)``, ``dv = p^T dout``,
    ``ds = p * (dout v^T - delta)``, ``dq = ds k * scale``, ``dk = ds^T q *
    scale`` summed over the G query heads of each KV head.
    """
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, Sq, KVH, G, hd) * scale
    do = dout.float().reshape(B, Sq, KVH, G, hd)
    og = out.float().reshape(B, Sq, KVH, G, hd)
    delta = (do * og).sum(dim=-1).permute(0, 2, 3, 1)  # (B, KVH, G, Sq)
    p = torch.exp(_scores(q, k, causal) - lse.reshape(B, KVH, G, Sq)[..., None])
    kf, vf = k.float(), v.float()
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, do)
    dp = torch.einsum("bqkgh,bskh->bkgqs", do, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg)
    return dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def conv2d_com_ref(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, padding: int = 1,
                   activation: Optional[str] = None) -> torch.Tensor:
    """x: (H, W, C); w: (K, K, C, M) — direct convolution as K² shifted
    ``(H_out·W_out, C) x (C, M)`` products into an f32 sum."""
    K = w.shape[0]
    xp = F.pad(x.float(), (0, 0, padding, padding, padding, padding))
    H_out = (x.shape[0] + 2 * padding - K) // stride + 1
    W_out = (x.shape[1] + 2 * padding - K) // stride + 1
    out = torch.zeros((H_out, W_out, w.shape[-1]), dtype=torch.float32, device=x.device)
    for kr in range(K):
        for kc in range(K):
            patch = xp[kr:kr + H_out * stride:stride, kc:kc + W_out * stride:stride, :]
            out = out + patch @ w[kr, kc].float()
    out = _epilogue(out, None, activation, None)
    return out.to(x.dtype)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``log(sigmoid(x))`` in the form ``jax.nn.log_sigmoid`` takes,
    ``min(x, 0) - log1p(exp(-|x|))``: finite for every finite ``x``. (The
    Pallas sLSTM kernel writes ``-log1p(exp(-x))``, which overflows to
    ``-inf`` for ``x < -88`` in float32; the two agree to f32 rounding
    wherever that form is finite.)"""
    return torch.minimum(x, torch.zeros_like(x)) - torch.log1p(torch.exp(-x.abs()))


SAVED_ROWS = 7  # the per-step state of slstm_ref(save=True): i, f, z, o, c, n, m


def slstm_ref(gx: torch.Tensor, rg: torch.Tensor, num_heads: int, *, save: bool = False):
    """The sLSTM recurrence over gate pre-activations, one step at a time.

    gx: ``(B, S, 4, D)`` pre-activations of the gates ``[i, f, z, o]`` (the
    input side ``x @ wg + bg``); rg: ``(4, H, hd, hd)`` recurrent weights,
    block-diagonal per head (``D = H * hd``). Returns ``h`` ``(B, S, D)`` in
    ``gx.dtype`` and the final state ``(c, n, h, m)``, each float32
    ``(B, H, hd)``. The cell is ``repro.models.xlstm._slstm_cell``: float32
    arithmetic, exponential gating stabilized by the running max ``m``
    (which starts at ``-1e30``; ``c``, ``n`` and ``h`` start at zero) and
    ``n`` clamped at ``1e-6``; ``h`` is rounded to ``gx.dtype`` only where
    it is written out.

    With ``save``, also the per-step state the backward reads
    (:func:`slstm_bwd_ref`), float32 ``(B, S, 7, D)``: at step t the four
    gate pre-activations after ``+ R h_{t-1}`` (rows 0-3) and ``c_t``,
    ``n_t``, ``m_t`` (rows 4-6), the layout the CUDA kernel writes. ``h`` is
    the same either way.
    """
    B, S, four, D = gx.shape
    hd = D // num_heads
    r = rg.float()
    c = torch.zeros((B, num_heads, hd), dtype=torch.float32, device=gx.device)
    n, h = torch.zeros_like(c), torch.zeros_like(c)
    m = torch.full_like(c, -1e30)
    out = torch.empty((B, S, D), dtype=gx.dtype, device=gx.device)
    saved = (torch.empty((B, S, SAVED_ROWS, D), dtype=torch.float32, device=gx.device)
             if save else None)
    for t in range(S):
        g = gx[:, t].float().reshape(B, 4, num_heads, hd)
        g = g + torch.einsum("bhn,ghnm->bghm", h, r)
        it, ft, zt, ot = g.unbind(1)
        logf = log_sigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i = torch.exp(it - m_new)
        f = torch.exp(logf + m - m_new)
        c = f * c + i * torch.tanh(zt)
        n = f * n + i
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
        m = m_new
        out[:, t] = h.reshape(B, D).to(gx.dtype)
        if save:
            saved[:, t, :4] = g.reshape(B, 4, D)
            saved[:, t, 4:] = torch.stack((c, n, m), 1).reshape(B, 3, D)
    if save:
        return out, (c, n, h, m), saved
    return out, (c, n, h, m)


def slstm_bwd_ref(rg: torch.Tensor, saved: torch.Tensor, dh: torch.Tensor, num_heads: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`slstm_ref`'s ``h``: ``(dgx, dR)`` from the
    recurrent weights, the forward's per-step state ``saved`` (float32
    ``(B, S, 7, D)``, ``slstm_ref(save=True)``) and ``dh`` ``(B, S, D)``, the
    gradient of ``h``. ``dgx`` ``(B, S, 4, D)`` is in ``dh.dtype`` (that is
    ``gx.dtype``), ``dR`` float32 ``(4, H, hd, hd)``. The reverse
    recurrence in float32, one step at a time, from ``t = S - 1`` down.

    The running max ``m`` is held constant. That is exact: because of the
    stabilizer, ``n_t >= 1`` at every step (``n_1 = i = 1``; afterwards
    either ``f = 1`` and ``n_t = n_{t-1} + i``, or ``i = 1`` and ``n_t =
    f n_{t-1} + 1``), so the ``1e-6`` clamp never acts, ``c`` and ``n``
    carry the same factor ``exp(-m)`` and ``h`` does not depend on ``m``:
    the gradient through ``m`` cancels. ``jax.grad`` of the reference's scan,
    which does differentiate through ``m`` (splitting a tie of ``max``
    0.5 / 0.5, as ``torch.maximum`` does), agrees to rounding. With ``m``
    fixed, ``i = exp(it - m_t)``, ``f = exp(logsigmoid(ft) + m_{t-1} - m_t)``
    and, with ``dh_t = dh[t] + R dg_{t+1}`` (R applied to the next step's
    gate gradients, ``R[q]`` contracted over its output unit):

        dc_t = dh_t σ(o) / n_t + f_{t+1} dc_{t+1}
        dn_t = -dh_t σ(o) c_t / n_t² + f_{t+1} dn_{t+1}
        dg_t = [(dc_t tanh z + dn_t) i, (dc_t c_{t-1} + dn_t n_{t-1}) f σ(-ft),
                dc_t i (1 - tanh² z), dh_t (c_t / n_t) σ(o) (1 - σ(o))]

    ``dR`` is :func:`slstm_dr` of the gate gradients.
    """
    B, S, _, D = saved.shape
    hd = D // num_heads
    r = rg.float()
    sv = saved.reshape(B, S, SAVED_ROWS, num_heads, hd)
    it, ft, zt, ot, c, n, m = sv.unbind(2)
    # the factors that do not depend on the reverse recurrence, for every step
    zero = torch.zeros((B, 1, num_heads, hd), dtype=torch.float32, device=saved.device)
    c_prev, n_prev = torch.cat((zero, c[:, :-1]), 1), torch.cat((zero, n[:, :-1]), 1)
    m_prev = torch.cat((torch.full_like(zero, -1e30), m[:, :-1]), 1)
    i = torch.exp(it - m)
    f = torch.exp(log_sigmoid(ft) + m_prev - m)
    tz, so = torch.tanh(zt), torch.sigmoid(ot)
    dc_dh, dn_dh = so / n, -so * c / (n * n)         # dh_t's share of dc_t and dn_t
    f_ft = f * torch.sigmoid(-ft)                     # df / dft
    z_dc, o_dh = i * (1 - tz * tz), (c / n) * so * (1 - so)
    dhf = dh.float().reshape(B, S, num_heads, hd)
    dg = torch.empty((B, S, 4, num_heads, hd), dtype=torch.float32, device=saved.device)
    dc, dn, f_next = zero[:, 0], zero[:, 0], zero[:, 0]
    dg_next = torch.zeros((B, 4, num_heads, hd), dtype=torch.float32, device=saved.device)
    for t in reversed(range(S)):
        dht = dhf[:, t] + torch.einsum("bghm,ghnm->bhn", dg_next, r)
        dc = dht * dc_dh[:, t] + dc * f_next
        dn = dht * dn_dh[:, t] + dn * f_next
        dg_next = torch.stack(((dc * tz[:, t] + dn) * i[:, t],
                               (dc * c_prev[:, t] + dn * n_prev[:, t]) * f_ft[:, t],
                               dc * z_dc[:, t], dht * o_dh[:, t]), 1)
        dg[:, t] = dg_next
        f_next = f[:, t]
    dg = dg.reshape(B, S, 4, D)
    return dg.to(dh.dtype), slstm_dr(saved, dg, num_heads)


def slstm_dr(saved: torch.Tensor, dg: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The recurrent weights' gradient, float32 ``(4, H, hd, hd)``: ``dR[q,
    h] = sum over (b, t) of h_{t-1}[b, h]^T dg_t[b, q, h]``, one product
    over the ``B * S`` rows, as the reference's scan transposes ``einsum("bhn,
    ghnm->bghm")``. ``h_{t-1}`` is the float32 carry ``σ(o) c / n`` of the
    previous step, recomputed from ``saved`` (zero at ``t = 0``); ``dg``
    float32 ``(B, S, 4, D)``."""
    B, S, _, D = saved.shape
    hd = D // num_heads
    h = torch.sigmoid(saved[:, :, 3]) * saved[:, :, 4] / torch.clamp(saved[:, :, 5], min=1e-6)
    h_prev = F.pad(h[:, :-1], (0, 0, 1, 0))  # (B, S, D), zero at t = 0
    hp = h_prev.reshape(B * S, num_heads, hd).permute(1, 2, 0)        # (H, hd, BS)
    dgr = dg.reshape(B * S, 4, num_heads, hd).permute(1, 2, 0, 3)     # (4, H, BS, hd)
    return torch.matmul(hp, dgr)
