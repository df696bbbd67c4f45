"""Mamba2 / SSD block (chunked state-space dual form), used by zamba2.

The port's copy of ``repro.models.ssm``, function for function, with the
same parameter names, layouts and cast points. Per-head scalar decay A,
softplus(dt), a depthwise causal conv over (x, B, C), the SSD chunked
algorithm (quadratic within a chunk, a state scan across chunks) for a
whole sequence, and an O(1) recurrent step for decode. ngroups = 1 (B and
C shared across heads). Every product is a plain ``einsum``: the reference
runs this block as plain XLA, with no Pallas kernel.

State layout (the decode cache), float32:
  conv: (B, W-1, conv_channels), the last W-1 *raw* (pre-conv) columns
  ssd : (B, H, N, P)

Where the port must be written with care to give the reference's numbers:

* :func:`ssd_chunked` masks the segment sums in log space *before* the
  exponential (``exp`` first would overflow, and ``inf · 0`` is NaN), and
  pads S to whole chunks with dt = 0, which leaves the final state as it is;
* :func:`_causal_conv` sums its W shifted products in order i = 0..W-1, in
  the activations' dtype (bfloat16 when served);
* :func:`mamba2_decode_step` concatenates the float32 conv state with the
  new column, which JAX promotes to float32, so the decode conv runs in
  **float32** where the prefill conv ran in the compute dtype; the port
  promotes explicitly.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, silu

State = Dict[str, torch.Tensor]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_axes() -> dict:
    """The logical axes of :func:`init_mamba2`'s parameters."""
    return {"in_proj": ("embed", "mlp"), "conv_w": (None, "mlp"), "conv_b": ("mlp",),
            "A_log": (None,), "D": (None,), "dt_bias": (None,), "norm_scale": ("mlp",),
            "out_proj": ("mlp", "embed")}


def init_mamba2(gen: torch.Generator, d: int, *, expand: int, head_dim: int, state_dim: int,
                conv_width: int) -> dict:
    inner = expand * d
    nheads = inner // head_dim
    conv_ch = inner + 2 * state_dim  # x + B + C
    dev = gen.device
    return {
        # fused input projection: [z(inner), x(inner), B(N), C(N), dt(H)]
        "in_proj": dense_init(gen, d, 2 * inner + 2 * state_dim + nheads),
        "conv_w": torch.randn((conv_width, conv_ch), generator=gen, device=dev)
        * (1.0 / math.sqrt(conv_width)),
        "conv_b": torch.zeros((conv_ch,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, device=dev)),
        "D": torch.ones((nheads,), device=dev),
        "dt_bias": torch.zeros((nheads,), device=dev),
        "norm_scale": torch.ones((inner,), device=dev),
        "out_proj": dense_init(gen, inner, d),
    }


def _split_proj(proj: torch.Tensor, inner: int, state_dim: int, nheads: int):
    z = proj[..., :inner]
    xbc = proj[..., inner:2 * inner + 2 * state_dim]
    dt = proj[..., 2 * inner + 2 * state_dim:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: xbc (B, S, C), w (W, C), in ``xbc.dtype``."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    return silu(out + b)


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int, init_state: Optional[torch.Tensor] = None):
    """SSD forward.

    x:  (B, S, H, P) inputs per head
    dt: (B, S, H)    positive step sizes
    A:  (H,)         negative decay rates
    Bm: (B, S, N)    input projections (ngroups=1)
    Cm: (B, S, N)    output projections
    Returns y (B, S, H, P) in ``x.dtype`` and the final state (B, H, N, P)
    float32. The reference's ``lax.scan`` over chunks is a loop here.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = (S + Q - 1) // Q
    pad = nc * Q - S
    dtype = x.dtype
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    x, dt, Bm, Cm = (t.float() for t in (x, dt, Bm, Cm))
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        la = dtq * A  # (B, Q, H) negative log-decay
        La = la.cumsum(dim=1)
        seg = La[:, :, None, :] - La[:, None, :, :]  # (B, t, s, H)
        # mask in log space before exp: for s > t seg is large and positive
        seg = seg.masked_fill(~tri[None, :, :, None], -1e30)
        decay = torch.exp(seg)
        cb = torch.einsum("btn,bsn->bts", Cq, Bq)
        w = cb[..., None] * decay * dtq[:, None, :, :]
        y = torch.einsum("btsh,bshp->bthp", w, xq)
        # inter-chunk: the contribution of the entering state h
        y = y + torch.einsum("btn,bth,bhnp->bthp", Cq, torch.exp(La), h)
        y = y + xq * D[None, None, :, None]
        # the state at the chunk's end
        dec_end = torch.exp(La[:, -1, None, :] - La)  # (B, Q, H)
        sb = torch.einsum("bsh,bsn,bshp->bhnp", dec_end * dtq, Bq, xq)
        h = h * torch.exp(La[:, -1])[:, :, None, None] + sb
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y[:, :S].to(dtype), h


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Mamba2's gated RMS norm: ``y · silu(z)``, normalised in float32,
    scaled, cast to ``dtype``."""
    y = y * silu(z)
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + 1e-5) * scale).to(dtype)


def mamba2_forward(params: Params, x: torch.Tensor, cfg, *, return_state: bool = False):
    """Full-sequence forward (prefill). x: (B, S, D).

    With ``return_state`` also returns the decode cache: the last W-1 raw
    (pre-conv) xBC columns, left-padded with zeros when S < W-1, and the
    final SSD state, both float32.
    """
    inner = cfg.ssm.expand * x.shape[-1]
    nheads = inner // cfg.ssm.head_dim
    N = cfg.ssm.state_dim
    proj = x @ params["in_proj"].to(x.dtype)
    z, xbc_raw, dt = _split_proj(proj, inner, N, nheads)
    xbc = _causal_conv(xbc_raw, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype))
    xs = xbc[..., :inner]
    Bm = xbc[..., inner:inner + N]
    Cm = xbc[..., inner + N:]
    B, S = x.shape[:2]
    xh = xs.reshape(B, S, nheads, cfg.ssm.head_dim)
    dt = _softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, h_final = ssd_chunked(xh, dt, A, Bm, Cm, params["D"], chunk=cfg.ssm.chunk)
    y = _gated_norm(y.reshape(B, S, inner), z, params["norm_scale"], x.dtype)
    out = y @ params["out_proj"].to(x.dtype)
    if not return_state:
        return out
    W = cfg.ssm.conv_width
    tail = F.pad(xbc_raw, (0, 0, W - 1 - S, 0)) if S < W - 1 else xbc_raw[:, S - (W - 1):]
    return out, {"conv": tail.float(), "ssd": h_final}


def init_mamba2_state(batch: int, d: int, cfg, dtype=torch.float32, device=None) -> State:
    inner = cfg.ssm.expand * d
    nheads = inner // cfg.ssm.head_dim
    conv_ch = inner + 2 * cfg.ssm.state_dim
    return {
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, conv_ch), dtype=dtype, device=device),
        "ssd": torch.zeros((batch, nheads, cfg.ssm.state_dim, cfg.ssm.head_dim), dtype=dtype,
                           device=device),
    }


def mamba2_decode_step(params: Params, x: torch.Tensor, state: State, cfg):
    """One-token step. x: (B, 1, D). Returns (y (B, 1, D), new_state), the
    new state in the given state's dtypes."""
    B, _, d = x.shape
    inner = cfg.ssm.expand * d
    nheads = inner // cfg.ssm.head_dim
    N = cfg.ssm.state_dim
    proj = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt = _split_proj(proj, inner, N, nheads)
    # the rolling conv runs in the promoted type of the state and the new
    # column (float32 for a float32 state), as jnp.concatenate promotes
    ct = torch.promote_types(state["conv"].dtype, x.dtype)
    conv_in = torch.cat([state["conv"].to(ct), xbc[:, :1].to(ct)], dim=1)  # (B, W, C)
    w = params["conv_w"].to(x.dtype).to(ct)
    out = torch.einsum("bwc,wc->bc", conv_in, w) + params["conv_b"].to(x.dtype)
    xbc = silu(out)
    new_conv = conv_in[:, 1:]

    xs = xbc[..., :inner].reshape(B, nheads, cfg.ssm.head_dim).float()
    Bm = xbc[..., inner:inner + N].float()
    Cm = xbc[..., inner + N:].float()
    dtv = _softplus(dt[:, 0].float() + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dtv * A)
    h = state["ssd"].float()
    h = h * decay[:, :, None, None] + torch.einsum("bh,bn,bhp->bhnp", dtv, Bm, xs)
    y = torch.einsum("bn,bhnp->bhp", Cm, h) + xs * params["D"][None, :, None]
    y = _gated_norm(y.reshape(B, 1, inner).to(x.dtype), z, params["norm_scale"], x.dtype)
    y = y @ params["out_proj"].to(x.dtype)
    return y, {"conv": new_conv.to(state["conv"].dtype), "ssd": h.to(state["ssd"].dtype)}
