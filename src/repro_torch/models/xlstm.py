"""xLSTM blocks (sLSTM + mLSTM) — used by xlstm-350m. [arXiv:2405.04517]

The port's copy of ``repro.models.xlstm``, function for function, with the
same parameter names, layouts and cast points: projections run in the
activation's dtype, the scans in float32, and the states are float32.

mLSTM: matrix memory C (N x N per head), exponential input gate with
max-stabilizer m, run as a chunked scan (state carried across chunks,
quadratic within a chunk) in plain PyTorch; the reference has no kernel
for it either.

sLSTM: scalar memory with recurrent gate connections (block-diagonal R per
head), strictly sequential. The reference runs it as a ``lax.scan`` over
:func:`_slstm_cell`; here a whole sequence goes through
:func:`repro_torch.kernels.ops.slstm` (the CUDA ``slstm_fused`` kernel on
the card), which computes what that scan computes, and a decode step stays
one :func:`_slstm_cell` of plain PyTorch.

Training: both blocks run under autograd. The mLSTM's gradient is autograd
through the chunked scan, as the reference's is ``jax.grad`` of its scan;
the sLSTM's is :class:`repro_torch.kernels.ops.SLSTMFused`, whose backward
is the hand-written reverse recurrence (``slstm_fused_bwd`` on the card).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import log_sigmoid
from repro_torch.models.layers import Params, dense_init

State = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_axes() -> dict:
    """The logical axes of :func:`init_mlstm`'s parameters."""
    return {"wq": ("embed", "heads"), "wk": ("embed", "heads"), "wv": ("embed", "heads"),
            "wi": ("embed", None), "wf": ("embed", None),
            "wo_gate": ("embed", "heads"), "wo": ("heads", "embed")}


def init_mlstm(gen: torch.Generator, d: int, num_heads: int) -> dict:
    return {
        "wq": dense_init(gen, d, d),
        "wk": dense_init(gen, d, d),
        "wv": dense_init(gen, d, d),
        "wi": dense_init(gen, d, num_heads),  # input gate (per head)
        "wf": dense_init(gen, d, num_heads),  # forget gate (per head)
        "wo_gate": dense_init(gen, d, d),     # sigmoid output gate
        "wo": dense_init(gen, d, d),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def _mlstm_chunk_scan(q, k, v, ig, fg, *, chunk: int, init_state=None):
    """q, k, v: (B, S, H, N); ig, fg: (B, S, H) pre-activation gates.

    Stabilized chunked mLSTM. Returns h (B, S, H, N) and the final state
    (C (B, H, N, N), n (B, H, N), m (B, H)), float32. A ragged S is padded
    to whole chunks with ig = 0 and fg = 30 (forget gate ~1), as the
    reference pads it; the padded steps move the final stabilizer m.
    """
    B, S, H, N = q.shape
    Q = min(chunk, S)
    nc = (S + Q - 1) // Q
    pad = nc * Q - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        ig = F.pad(ig, (0, 0, 0, pad))
        fg = F.pad(fg, (0, 0, 0, pad), value=30.0)  # e^30 ~ keep

    f32 = torch.float32
    qc = q.reshape(B, nc, Q, H, N).to(f32) / math.sqrt(N)
    kc = k.reshape(B, nc, Q, H, N).to(f32)
    vc = v.reshape(B, nc, Q, H, N).to(f32)
    igc = ig.reshape(B, nc, Q, H).to(f32)
    logf = log_sigmoid(fg.reshape(B, nc, Q, H).to(f32))
    Fc = torch.cumsum(logf, dim=2)  # within-chunk cumulative log forget
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))

    if init_state is None:
        C = torch.zeros((B, H, N, N), dtype=f32, device=q.device)
        n = torch.zeros((B, H, N), dtype=f32, device=q.device)
        m = torch.full((B, H), -1e30, dtype=f32, device=q.device)
    else:
        C, n, m = init_state
    hs = []
    for ci in range(nc):
        qb, kb, vb, ib, Fb = qc[:, ci], kc[:, ci], vc[:, ci], igc[:, ci], Fc[:, ci]
        Ftot = Fb[:, -1]  # (B, H) total chunk log-forget
        # log weight of step s's contribution at chunk end: Ftot - F_s + i_s
        a = Ftot[:, None] - Fb + ib  # (B, Q, H)
        # intra-chunk: D[t, s] = F_t - F_s + i_s (s <= t)
        Dm = Fb[:, :, None, :] - Fb[:, None, :, :] + ib[:, None, :, :]  # (B, t, s, H)
        Dm = Dm.masked_fill(~tri[None, :, :, None], float("-inf"))
        # inter-chunk log weight at step t: F_t + m_prev
        inter_w = Fb + m[:, None, :]  # (B, Q, H)
        m_intra = Dm.amax(dim=2)  # (B, t, H)
        m_new_t = torch.maximum(m_intra, inter_w)  # running stabilizer per t
        s = torch.einsum("bthn,bshn->btsh", qb, kb)
        w_intra = torch.exp(Dm - m_new_t[:, :, None, :]) * s
        h_num = torch.einsum("btsh,bshn->bthn", w_intra, vb)
        # the normalizer accumulates the same exp-weighted scores
        n_intra = w_intra.sum(dim=2)  # (B, t, H)
        w_inter = torch.exp(inter_w - m_new_t)  # (B, t, H)
        h_num = h_num + w_inter[..., None] * torch.einsum("bthn,bhnm->bthm", qb, C)
        n_t = n_intra + w_inter * torch.einsum("bthn,bhn->bth", qb, n)
        hs.append(h_num / torch.maximum(n_t.abs(), torch.exp(-m_new_t))[..., None])
        # state update to the chunk's end
        m_end = torch.maximum(Ftot + m, a.amax(dim=1))  # (B, H)
        decay = torch.exp(Ftot + m - m_end)
        contrib = torch.exp(a - m_end[:, None])  # (B, Q, H)
        C = C * decay[:, :, None, None] + torch.einsum("bsh,bshn,bshm->bhnm", contrib, kb, vb)
        n = n * decay[:, :, None] + torch.einsum("bsh,bshn->bhn", contrib, kb)
        m = m_end
    h = torch.stack(hs, dim=1).reshape(B, nc * Q, H, N)[:, :S]
    return h, (C, n, m)


def mlstm_forward(params: Params, x: torch.Tensor, num_heads: int, *, chunk: int = 128,
                  return_state: bool = False):
    B, S, d = x.shape
    hd = d // num_heads
    q = _proj(x, params["wq"]).reshape(B, S, num_heads, hd)
    k = _proj(x, params["wk"]).reshape(B, S, num_heads, hd)
    v = _proj(x, params["wv"]).reshape(B, S, num_heads, hd)
    ig = _proj(x, params["wi"])
    fg = _proj(x, params["wf"])
    h, (C, n, m) = _mlstm_chunk_scan(q, k, v, ig, fg, chunk=chunk)
    og = torch.sigmoid(_proj(x, params["wo_gate"]))
    h = h.reshape(B, S, d).to(x.dtype) * og
    out = _proj(h, params["wo"])
    if return_state:
        return out, {"C": C, "n": n, "m": m}
    return out


def init_mlstm_state(batch: int, d: int, num_heads: int, dtype=torch.float32,
                     device=None) -> State:
    hd = d // num_heads
    return {
        "C": torch.zeros((batch, num_heads, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros((batch, num_heads, hd), dtype=dtype, device=device),
        "m": torch.full((batch, num_heads), -1e30, dtype=dtype, device=device),
    }


def mlstm_decode_step(params: Params, x: torch.Tensor, state: State, num_heads: int):
    """x: (B, 1, D)."""
    B, _, d = x.shape
    hd = d // num_heads
    f32 = torch.float32
    q = _proj(x, params["wq"]).reshape(B, num_heads, hd).to(f32) / math.sqrt(hd)
    k = _proj(x, params["wk"]).reshape(B, num_heads, hd).to(f32)
    v = _proj(x, params["wv"]).reshape(B, num_heads, hd).to(f32)
    ig = _proj(x, params["wi"])[:, 0].to(f32)
    fg = _proj(x, params["wf"])[:, 0].to(f32)
    logf = log_sigmoid(fg)
    C, n, m = state["C"].to(f32), state["n"].to(f32), state["m"].to(f32)
    m_new = torch.maximum(logf + m, ig)
    decay = torch.exp(logf + m - m_new)
    inp = torch.exp(ig - m_new)
    C = C * decay[..., None, None] + inp[..., None, None] * torch.einsum("bhn,bhm->bhnm", k, v)
    n = n * decay[..., None] + inp[..., None] * k
    num = torch.einsum("bhn,bhnm->bhm", q, C)
    den = torch.maximum(torch.einsum("bhn,bhn->bh", q, n).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, d).to(x.dtype)
    og = torch.sigmoid(_proj(x, params["wo_gate"]))
    y = _proj(h * og, params["wo"])
    new_state = {"C": C.to(state["C"].dtype), "n": n.to(state["n"].dtype),
                 "m": m_new.to(state["m"].dtype)}
    return y, new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_axes() -> dict:
    """The logical axes of :func:`init_slstm`'s parameters."""
    return {"wg": ("embed", "heads"), "rg": (None, None, None, None), "bg": ("heads",),
            "wo": ("heads", "embed")}


def init_slstm(gen: torch.Generator, d: int, num_heads: int) -> dict:
    hd = d // num_heads
    return {
        # gates [i, f, z, o] from input
        "wg": dense_init(gen, d, 4 * d),
        # block-diagonal recurrent weights per head: (4, H, hd, hd)
        "rg": torch.randn((4, num_heads, hd, hd), generator=gen, device=gen.device)
        * (1.0 / math.sqrt(hd)),
        "bg": torch.zeros((4 * d,), device=gen.device),
        "wo": dense_init(gen, d, d),
    }


def init_slstm_state(batch: int, d: int, num_heads: int, dtype=torch.float32,
                     device=None) -> State:
    hd = d // num_heads
    z = lambda: torch.zeros((batch, num_heads, hd), dtype=dtype, device=device)  # noqa: E731
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, num_heads, hd), -1e30, dtype=dtype, device=device)}


def _slstm_cell(params: Params, gx: torch.Tensor, state: State, num_heads: int,
                hd: int) -> State:
    """gx: (B, 4d) input-gate preactivations for one step."""
    B = gx.shape[0]
    f32 = torch.float32
    c, n, h, m = (state[k].to(f32) for k in ("c", "n", "h", "m"))
    g = gx.to(f32).reshape(B, 4, num_heads, hd)
    g = g + torch.einsum("bhn,ghnm->bghm", h, params["rg"].to(f32))
    it, ft, zt, ot = g.unbind(1)
    logf = log_sigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i = torch.exp(it - m_new)
    f = torch.exp(logf + m - m_new)
    c = f * c + i * torch.tanh(zt)
    n = f * n + i
    h_new = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
    return {"c": c.to(state["c"].dtype), "n": n.to(state["n"].dtype),
            "h": h_new.to(state["h"].dtype), "m": m_new.to(state["m"].dtype)}


def slstm_forward(params: Params, x: torch.Tensor, num_heads: int, *,
                  return_state: bool = False, backend: Optional[str] = None):
    """The whole sequence through the fused recurrence. x: (B, S, D).

    The gate pre-activations ``gx`` and ``h`` stay in the compute dtype
    (bf16), the cell math is float32. ``backend`` goes to
    :func:`repro_torch.kernels.ops.slstm` (None: the tensor's device decides).
    """
    B, S, d = x.shape
    gx = (_proj(x, params["wg"]) + params["bg"].to(x.dtype)).reshape(B, S, 4, d)
    h, (c, n, hs, m) = ops.slstm(gx, params["rg"], num_heads, backend=backend)
    out = _proj(h, params["wo"])
    if return_state:
        return out, {"c": c, "n": n, "h": hs, "m": m}
    return out


def slstm_decode_step(params: Params, x: torch.Tensor, state: State, num_heads: int):
    B, _, d = x.shape
    hd = d // num_heads
    gx = _proj(x, params["wg"])[:, 0] + params["bg"].to(x.dtype)
    new = _slstm_cell(params, gx, state, num_heads, hd)
    y = _proj(new["h"].reshape(B, 1, d).to(x.dtype), params["wo"])
    return y, new


# a pair's states as the model's cache leaves, in the order of
# ``jax.tree.leaves`` on the reference's {"mlstm": ..., "slstm": ...}
STATE_LEAVES = ("mlstm.C", "mlstm.m", "mlstm.n", "slstm.c", "slstm.h", "slstm.m", "slstm.n")


def state_leaves(m_state: State, s_state: State) -> Tuple[torch.Tensor, ...]:
    """One pair's mLSTM and sLSTM state dicts as a tuple in STATE_LEAVES order."""
    both = {"mlstm": m_state, "slstm": s_state}
    return tuple(both[block][key] for block, key in (n.split(".") for n in STATE_LEAVES))


def leaf_states(leaves) -> Tuple[State, State]:
    """The inverse of :func:`state_leaves`: the (mLSTM, sLSTM) state dicts."""
    both: Dict[str, State] = {"mlstm": {}, "slstm": {}}
    for name, t in zip(STATE_LEAVES, leaves):
        block, key = name.split(".")
        both[block][key] = t
    return both["mlstm"], both["slstm"]
