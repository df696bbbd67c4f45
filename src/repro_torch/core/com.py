"""Computing-On-the-Move collectives over ``torch.distributed``.

The port's copy of ``repro.core.com``. Domino's key mechanism — partial
sums accumulated hop by hop between tiles instead of shipped to a global
buffer — becomes a ring reduce-scatter between ranks: at every hop each
rank adds its local partial block to the arriving accumulator and forwards
it to its neighbour. Compared with an all-reduce after a row-sharded
matmul this

  * moves (n-1)/n of the output's bytes a rank instead of 2(n-1)/n,
  * computes the partial block of each hop just before it is added, and
  * lands the result distributed (output-stationary on the last rank),
    with the ROFM epilogue (bias, activation, residual) on the final hop.

One process per rank. The reference's ``axis_name`` is a process group
here, e.g. ``mesh.get_group("model")`` of a ``DeviceMesh``
(``repro_torch.launch.mesh``). A hop is one ``dist.batch_isend_irecv``
pair: send to ring rank ``(me + shift) % n``, receive from ``(me - shift) %
n``. The schedule is the reference's: the accumulator starts as the part
for ``(me - 1) % n`` and hop ``t`` adds the part for ``(me - t - 2) % n``,
so every addition happens in the reference's order.

Transport. PyTorch's table of backends marks ``gloo``'s send and receive
CPU only: handed a CUDA tensor, gloo's send aborts the rank
(``scripts/gloo_cuda_probe.py``). So a hop of a CUDA tensor in a ``gloo``
group (ranks that share one card, where NCCL refuses a second rank on a
GPU) crosses through pinned host memory; the group's backend decides this
(:func:`staged`). gloo's all-reduce takes CUDA tensors itself (the table,
and the probe), so :func:`all_reduce` stages nothing. Every send and
all-reduce adds to :data:`counters`, which the tests and ``chip_smoke.py``
hold to ``repro_torch.parallel.collectives.wire_bytes``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.ref import _epilogue


@dataclasses.dataclass
class Counters:
    """What this process sent: point-to-point sends (one a tensor a hop)
    and their payload bytes; all-reduces and the bytes of the tensors they
    reduced (a ring all-reduce puts 2(n-1)/n of those on the wire)."""

    sends: int = 0
    bytes_sent: int = 0
    all_reduces: int = 0
    all_reduce_bytes: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


counters = Counters()


def _ring_perm(n: int, shift: int = 1):
    return [(i, (i + shift) % n) for i in range(n)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def staged(t: torch.Tensor, group) -> bool:
    """Whether a hop carries ``t`` across ``group`` through pinned host
    memory: a CUDA tensor in a ``gloo`` group (gloo sends host memory)."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def hop(sends: Sequence[Tuple[torch.Tensor, int]], group) -> List[torch.Tensor]:
    """One ring hop of each ``(tensor, shift)``, posted together in one
    ``batch_isend_irecv``: ``tensor`` goes to ring rank ``(me + shift) %
    n`` and the returned tensor (on ``tensor``'s device) came from ``(me -
    shift) % n``. Sends of one hop carry distinct tags, so two that share a
    peer (n = 2, both directions) cannot cross."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    ops, recvs = [], []
    for tag, (t, shift) in enumerate(sends):
        perm = _ring_perm(n, shift)  # (source, destination) pairs, as ppermute takes them
        dst = dict(perm)[me]
        src = next(i for i, j in perm if j == me)
        stage = staged(t, group)
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t) if stage \
            else t.contiguous()
        out = torch.empty(buf.shape, dtype=buf.dtype, device=buf.device, pin_memory=stage)
        ops.append(dist.P2POp(dist.isend, buf, dist.get_global_rank(group, dst), group, tag))
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group, tag))
        recvs.append((out, t.device))
        counters.sends += 1
        counters.bytes_sent += _nbytes(buf)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [out.to(device) for out, device in recvs]


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor on ``t``'s device)."""
    buf = t.clone(memory_format=torch.contiguous_format)
    counters.all_reduces += 1
    counters.all_reduce_bytes += _nbytes(buf)
    dist.all_reduce(buf, group=group)
    return buf


# ---------------------------------------------------------------------------
# COM ring reduce-scatter and all-gather
# ---------------------------------------------------------------------------


def com_reduce_scatter(x_parts: torch.Tensor, group) -> torch.Tensor:
    """Ring reduce-scatter with on-the-move accumulation.

    x_parts: (n, chunk, ...) — this rank's partial contribution for each of
    the n destination shards (n = the group's size). Returns this rank's
    fully reduced chunk: (chunk, ...).

    Hop t: the accumulator for destination d = (me - t - 2) mod n arrives;
    we add our local partial for that destination and forward it. After
    n-1 hops the accumulator for ``me`` has visited everyone — Domino's
    partial-sum chain."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x_parts[0]
    acc = x_parts[(me - 1) % n]
    for t in range(n - 1):
        (acc,) = hop([(acc, 1)], group)
        acc = acc + x_parts[(me - t - 2) % n]
    return acc


def com_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Ring all-gather by hops (IFM streaming plane / RIFM analogue):
    (n,) + x.shape, row ``i`` from ring rank ``i``."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x[None]
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[me] = x
    cur = x
    for t in range(n - 1):
        (cur,) = hop([(cur, 1)], group)
        buf[(me - t - 1) % n] = cur
    return buf


# ---------------------------------------------------------------------------
# COM matmul: row-parallel matmul with ring accumulation + fused epilogue
# ---------------------------------------------------------------------------


def com_matmul_local(x_local: torch.Tensor, w_local: torch.Tensor, group, *,
                     bias_local: Optional[torch.Tensor] = None,
                     epilogue: Optional[str] = None,       # None | "relu" | "silu" | "gelu"
                     residual_local: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_local (..., K/n), w_local (K/n, N) -> (..., N/n), this rank's
    output columns (output-stationary). The partial block of each hop is
    computed just before it is added. Epilogue (ROFM inter-memory
    functions, Tab. II): bias add (Add), activation (Act; gelu is the tanh
    form, as ``jax.nn.gelu``'s default), residual shortcut (Bp) — on the
    final hop only."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    N = w_local.shape[-1]
    if N % n:
        raise ValueError(f"N = {N} does not split over {n} ranks")
    chunk = N // n

    def w_chunk(d):
        return w_local[:, d * chunk:(d + 1) * chunk]

    if n == 1:
        out = x_local @ w_local
    else:
        out = x_local @ w_chunk((me - 1) % n)
        for t in range(n - 1):
            (out,) = hop([(out, 1)], group)
            out = out + x_local @ w_chunk((me - t - 2) % n)
    return _epilogue(out, bias_local, epilogue, residual_local)


def _placements(mesh, axis: str, dim: int):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(dim) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def _split(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"a dimension of {size} does not split over {n} ranks")
    return t.narrow(dim, i * (size // n), size // n)


def make_com_matmul(mesh, axis: str = "model"):
    """Returns ``com_mm(x, w, *, bias=None, epilogue=None, residual=None)``
    for a ``DeviceMesh``: every rank passes the global x (..., K), w (K, N)
    and (N,) bias / (..., N) residual; the rank takes its K slice of x and
    w and its N slice of bias and residual (the reference's in_specs) and
    returns the output N-sharded over ``axis`` as a ``DTensor``
    (``Shard(ndim - 1)``, replicated over the other axes), whose
    ``full_tensor()`` is the reference's global result. The tensors must
    lie on the mesh's device type."""
    group = mesh.get_group(axis)

    def com_mm(x, w, *, bias=None, epilogue=None, residual=None):
        from torch.distributed.tensor import DTensor

        for t in (x, w, bias, residual):
            if t is not None and t.device.type != mesh.device_type:
                raise ValueError(f"a {t.device.type} tensor on a {mesh.device_type} mesh")
        n, me = dist.get_world_size(group), dist.get_rank(group)
        out = com_matmul_local(
            _split(x, -1, n, me), _split(w, 0, n, me), group,
            bias_local=None if bias is None else _split(bias, 0, n, me), epilogue=epilogue,
            residual_local=None if residual is None else _split(residual, -1, n, me))
        return DTensor.from_local(out, mesh, _placements(mesh, axis, x.ndim - 1),
                                  run_check=False)

    return com_mm


# ---------------------------------------------------------------------------
# Bidirectional COM ring — halves hop latency (beyond the paper: both link
# directions at once, like Domino's dual-router planes)
# ---------------------------------------------------------------------------


def com_matmul_local_bidir(x_local: torch.Tensor, w_local: torch.Tensor, group) -> torch.Tensor:
    """As :func:`com_matmul_local` but each chunk split across two
    counter-rotating rings, both directions' hops posted together."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    N = w_local.shape[-1]
    chunk = N // n
    if n == 1:
        return x_local @ w_local
    half = chunk // 2

    def w_chunk(d, lo, size):
        return w_local[:, d * chunk + lo:d * chunk + lo + size]

    a_fw = x_local @ w_chunk((me - 1) % n, 0, half)
    a_bw = x_local @ w_chunk((me + 1) % n, half, chunk - half)
    for t in range(n - 1):
        a_fw, a_bw = hop([(a_fw, 1), (a_bw, -1)], group)
        a_fw = a_fw + x_local @ w_chunk((me - t - 2) % n, 0, half)
        a_bw = a_bw + x_local @ w_chunk((me + t + 2) % n, half, chunk - half)
    return torch.cat([a_fw, a_bw], dim=-1)
