"""Whole-program batched executor: image → logits through a CompiledProgram.

The PyTorch port's counterpart of ``repro.core.executor``. It runs an
entire :class:`~repro_torch.core.program.CompiledProgram` end to end —
every layer's block chain, each layer's OFM (after the fused M-type
pooling, when present) feeding the next layer's IFM (conv→conv,
conv→flatten→FC, FC→FC) — batched over a leading image axis.

Two backends:

* ``"cuda"`` (the default) — the JAX package's ``"jax"`` backend on the
  card: every conv layer is an im2col in ``(kr, kc, c)`` order times
  ``w.reshape(K·K·C, M)``, and every conv and FC product goes through
  :func:`repro_torch.kernels.ops.com_matmul`, i.e. the CUDA ``com_matmul``
  kernel, with the ReLU fused on every layer (the final FC logits
  included); max-pool follows the activation and a flatten precedes the
  first FC. It works in float32. The im2col, max-pool and flatten are
  ordinary PyTorch ops, as they are XLA ops in the JAX package.
* ``"reference"`` — the block chains in plain float64 PyTorch
  (``run_conv_block_chain`` / ``run_fc_block_chain``), the counterpart of
  the JAX package's NumPy oracle, on whatever device it is given.

``device=None`` means the card. ``backend="cuda"`` on the CPU, or with no
card, raises. Event accounting is backend-independent: per-image events
are recounted from the explicit block grids and equal the program's
``event_totals``. Weight faults (``faults=``, or the program's own
FaultSet) are realized once on the host, on the float64 weight list,
before it moves to the device, so both backends consume the same faulted
values. ``shard=`` splits the image batch over several devices of one
process (:func:`sharded_forward`), the counterpart of the JAX package's
``shard_map`` over a ``("data",)`` mesh of the local devices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.convert import host_weights, resolve_device, to_port, weight_shape
from repro_torch.core.mapping import ConvSpec
from repro_torch.core.simulator import (
    EVENT_FIELDS,
    Events,
    conv_block_events,
    fc_block_events,
    run_conv_block_chain,
    run_fc_block_chain,
)
from repro_torch.kernels import ops

BACKENDS: Tuple[str, ...] = ("cuda", "reference")


def _pooled_hw(layer: ConvSpec) -> Tuple[int, int]:
    """Feature-map height/width after the layer's fused pooling (if any)."""
    h, w = layer.h_out, layer.w_out
    if layer.pool_k > 0:
        k, s = layer.pool_k, layer.pool_stride
        h, w = (h - k) // s + 1, (w - k) // s + 1
    return h, w


def _chain_shapes(layers) -> List[Tuple[int, ...]]:
    """Validate that every layer's OFM feeds the next layer's IFM; return
    the per-layer *input* shapes (without the batch axis)."""
    shapes: List[Tuple[int, ...]] = []
    prev: Optional[Tuple[int, ...]] = None  # OFM shape after pooling/flatten
    problems: List[str] = []
    for i, l in enumerate(layers):
        if isinstance(l, ConvSpec):
            if l.residual_from is not None:
                raise NotImplementedError(
                    f"layer {l.name!r} has residual_from={l.residual_from!r}: "
                    "the whole-program executor chains straight-line "
                    "conv/FC programs (VGG-class); residual joins are not "
                    "executed functionally yet"
                )
            want = (l.h_in, l.w_in, l.c_in)
            if prev is not None and prev != want:
                problems.append(
                    f"layers[{i}] ({l.name!r}) expects IFM {want}, but the "
                    f"previous layer produces {prev}"
                )
            shapes.append(want)
            prev = _pooled_hw(l) + (l.c_out,)
        else:
            want = (l.c_in,)
            if prev is not None:
                got = prev if len(prev) == 1 else (int(np.prod(prev)),)
                if got != want:
                    problems.append(
                        f"layers[{i}] ({l.name!r}) expects {l.c_in} inputs, "
                        f"but the previous layer produces {prev} "
                        f"(flattens to {got[0]})"
                    )
            shapes.append(want)
            prev = (l.c_out,)
    if problems:
        raise ValueError(
            "workload is not an executable image→logits chain:\n"
            + "\n".join(problems)
        )
    return shapes


def random_weights(program_or_workload, seed: int = 0) -> Dict[str, np.ndarray]:
    """He-scaled random weights for every layer, keyed by layer name.

    The JAX package's generator and draw order, so the same seed gives
    the same float64 arrays bit for bit.
    """
    from repro_torch.core.program import CompiledProgram

    layers = (program_or_workload.workload.layers
              if isinstance(program_or_workload, CompiledProgram)
              else tuple(program_or_workload))
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for l in layers:
        shape = weight_shape(l)
        fan_in = int(np.prod(shape[:-1]))
        out[l.name] = rng.normal(scale=np.sqrt(2.0 / fan_in), size=shape)
    return out


def _maxpool(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Max pool (B, H, W, C) with window k, stride s — the functional twin
    of the M-type CMP chain (``Func.CMP``) the schedule compiler emits."""
    _, H, W, _ = x.shape
    Ho, Wo = (H - k) // s + 1, (W - k) // s + 1
    out = None
    for i in range(k):
        for j in range(k):
            v = x[:, i:i + (Ho - 1) * s + 1:s, j:j + (Wo - 1) * s + 1:s, :]
            out = v if out is None else torch.maximum(out, v)
    return out


def com_forward(program, weights: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The kernel path: per conv layer an im2col in ``(kr, kc, c)`` order
    and one ``com_matmul`` with the ReLU fused, then max-pool; flatten
    before the first FC; per FC layer one ``com_matmul`` with the ReLU
    fused. ``weights`` are in the kernel layout (``repro_torch.convert``).
    On a CUDA tensor every product launches the CUDA kernel; on a CPU
    tensor it takes the plain version."""
    for lp, w in zip(program.layer_programs, weights):
        l = lp.layer
        if isinstance(l, ConvSpec):
            K, P, S = l.k, l.padding, l.stride
            Ho, Wo = l.h_out, l.w_out
            B = x.shape[0]
            xp = F.pad(x, (0, 0, P, P, P, P))
            cols = [
                xp[:, kr:kr + (Ho - 1) * S + 1:S, kc:kc + (Wo - 1) * S + 1:S, :]
                for kr in range(K) for kc in range(K)
            ]
            patches = torch.cat(cols, dim=-1).reshape(B * Ho * Wo, K * K * l.c_in)
            y = ops.com_matmul(patches, w, activation="relu").reshape(B, Ho, Wo, l.c_out)
            if l.pool_k > 0:
                y = _maxpool(y, l.pool_k, l.pool_stride)
            x = y
        else:
            if x.dim() > 2:
                x = x.reshape(x.shape[0], -1)  # conv→flatten→FC
            x = ops.com_matmul(x, w, activation="relu")
    return x


def reference_forward(program, weights: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The float64 block-chain walk (``run_*_block_chain``), pooling and
    flatten included; ``weights`` are in the kernel layout."""
    for lp, w in zip(program.layer_programs, weights):
        l = lp.layer
        if isinstance(l, ConvSpec):
            x = run_conv_block_chain(lp, w.view(l.k, l.k, l.c_in, l.c_out), x)
            if l.pool_k > 0:
                x = _maxpool(x, l.pool_k, l.pool_stride)
        else:
            if x.dim() > 2:
                x = x.reshape(x.shape[0], -1)
            x = run_fc_block_chain(lp, w, x)
    return x


def sharded_forward(forward, program, weights: Mapping[torch.device, List[torch.Tensor]],
                    x: torch.Tensor, devices: Sequence[torch.device]) -> torch.Tensor:
    """``forward(program, weights, x)`` with the batch axis split over
    ``devices``: ``x`` is zero-padded to a multiple of ``len(devices)``,
    shard ``i`` runs on ``devices[i]`` with ``weights[devices[i]]`` (the
    shards are launched in turn; launches on different cards overlap by
    themselves), the outputs gather on ``x``'s device and the pad rows are
    sliced off. The chain has no cross-image arithmetic, so each image's
    logits are those of the unsharded forward wherever a shard's products
    round as the whole batch's do (see :class:`ProgramExecutor`)."""
    n, b = len(devices), x.shape[0]
    pad = (-b) % n
    if pad:  # B need not divide the device count: pad rows are sliced off
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    per = x.shape[0] // n
    outs = [forward(program, weights[d], x[i * per:(i + 1) * per].to(d))
            for i, d in enumerate(devices)]
    return torch.cat([o.to(x.device) for o in outs])[:b]


def _canonical(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so equal devices compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class ExecutionResult:
    """One batched program run: outputs + per-image events + timing."""

    outputs: torch.Tensor        # (B, c_out_last) logits (post-activation)
    events: Mapping[str, int]    # per-image totals == program.event_totals
    backend: str
    batch: int
    wall_s: float                # host clock, images copied in and synchronized
    n_shards: int = 1            # devices the batch axis was split over

    @property
    def images_s(self) -> float:
        return self.batch / max(self.wall_s, 1e-12)


class ProgramExecutor:
    """Runs a whole :class:`CompiledProgram` image→logits, batched.

    ``weights`` is a mapping ``layer name → ndarray`` (conv ``(K, K, C,
    M)``, FC ``(C_in, C_out)``) or a sequence aligned with the workload's
    layers, as the JAX package's executor takes them. ``backend`` is
    ``"cuda"`` (the CUDA ``com_matmul`` kernel path, float32) or
    ``"reference"`` (float64 block chains); ``device=None`` means the
    card.

    ``faults`` (a :class:`repro_torch.faults.FaultSet`) realizes weight-cell
    faults and logical-tile dropout on the float64 weights
    (:func:`repro_torch.faults.apply_weight_faults`, on the host) before
    they move to the device; ``faults=None`` inherits ``program.faults``.
    ``fault_info`` holds the realization's summary (``n_cells``,
    ``n_blocks``, ``mask_checksum``), or None when no weight was faulted.

    ``shard`` splits the leading image axis over devices of this process
    (``"cuda"`` backend only; the float64 reference is single-device):
    ``None``/``False`` is off; ``"auto"``, ``"data"`` or ``True`` take every
    visible device of the executor's type; a sequence of ``torch.device``
    is an explicit list, and may repeat a device (``[cuda:0, cuda:0]``
    drives the split path on a machine with one card). One device falls
    back to the unsharded path. The weights are copied once to each
    distinct device; the batch is zero-padded to a multiple of
    ``n_shards`` (:func:`sharded_forward`). The logits equal the
    unsharded path's bit for bit for every product whose
    ``com_matmul`` plan (split-K, chosen from the output tile count) is
    the same at a shard's rows as at the whole batch's, and lie within
    ``2e-5 · max|ref|`` otherwise.
    """

    def __init__(self, program, weights, *, backend: str = "cuda", device=None,
                 faults=None, shard=None):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown executor backend {backend!r}; available: {list(BACKENDS)}")
        self.device = resolve_device(device)
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"backend='cuda' runs on a CUDA device, not {self.device}; use "
                "backend='reference' to run on the CPU")
        self.program = program
        self.backend = backend
        self.dtype = torch.float32 if backend == "cuda" else torch.float64
        self._shards = self._resolve_shard(shard)
        layers = program.workload.layers
        self.input_shape = _chain_shapes(layers)[0]
        self.faults = faults if faults is not None else program.faults
        self.fault_info: Optional[Dict[str, float]] = None
        if self.faults is not None and self.faults.has_workload_faults:
            from repro_torch.faults.inject import apply_weight_faults

            weights, self.fault_info = apply_weight_faults(
                layers, host_weights(layers, weights), self.faults, program.arch)
        self.weights = to_port(layers, weights, dtype=self.dtype, device=self.device)
        self._events: Optional[Dict[str, int]] = None
        self._shard_weights = None
        if self._shards is not None:
            home = _canonical(self.device)
            self._shard_weights = {d: self.weights if d == home else
                                   [w.to(d) for w in self.weights] for d in set(self._shards)}

    def _resolve_shard(self, shard) -> Optional[List[torch.device]]:
        """``shard`` → the devices of each shard (two or more), or None
        (sharding off, or one device)."""
        if shard is None or shard is False:
            return None
        if self.backend != "cuda":
            raise ValueError(f"shard={shard!r} requires backend='cuda'; the float64 reference "
                             "is single-device by design")
        if isinstance(shard, str) or shard is True:
            if shard not in ("auto", "data", True):
                raise ValueError(f"shard={shard!r}: expected 'auto', 'data', True, or a "
                                 "sequence of torch.device")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [_canonical(torch.device(d)) for d in shard]
            wrong = [str(d) for d in devices if d.type != self.device.type]
            if not devices or wrong:
                raise ValueError(f"shard={shard!r}: expected a non-empty sequence of "
                                 f"{self.device.type} devices")
        return devices if len(devices) > 1 else None

    @property
    def n_shards(self) -> int:
        """Devices the batch axis is split over (1 = unsharded)."""
        return len(self._shards) if self._shards is not None else 1

    @property
    def events(self) -> Dict[str, int]:
        """Per-image event totals, recounted from the explicit block grids
        — equal to ``program.event_totals``."""
        if self._events is None:
            total = Events()
            arch = self.program.arch
            for lp in self.program.layer_programs:
                if isinstance(lp.layer, ConvSpec):
                    total.merge(conv_block_events(lp, arch))
                else:
                    total.merge(fc_block_events(lp, arch))
            self._events = {f: getattr(total, f) for f in EVENT_FIELDS}
        return dict(self._events)

    def _batch(self, images) -> torch.Tensor:
        x = torch.as_tensor(images)
        want = self.input_shape
        if tuple(x.shape) == want:             # single image convenience
            x = x[None]
        if x.dim() != len(want) + 1 or tuple(x.shape[1:]) != want:
            raise ValueError(
                f"images shape {tuple(x.shape)} does not match the program's "
                f"input {want} (optionally with a leading batch axis)")
        return x

    def _sync(self):
        for d in {self.device, *(self._shards or ())}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def run(self, images) -> ExecutionResult:
        """Execute the whole program on a batch of images → logits."""
        x = self._batch(images)
        self._sync()
        t0 = time.perf_counter()
        x = x.to(device=self.device, dtype=self.dtype)
        forward = com_forward if self.backend == "cuda" else reference_forward
        if self._shards is None:
            out = forward(self.program, self.weights, x)
        else:
            out = sharded_forward(forward, self.program, self._shard_weights, x, self._shards)
        self._sync()
        wall = time.perf_counter() - t0
        return ExecutionResult(
            outputs=out, events=self.events, backend=self.backend,
            batch=x.shape[0], wall_s=wall, n_shards=self.n_shards,
        )

    def __call__(self, images) -> torch.Tensor:
        return self.run(images).outputs
