"""Weights of the JAX package → the port's tensors, and back.

Two kinds of weights: the executor's per-layer arrays (below), and a
language model's parameter pytree (:func:`model_params_to_port`). Fault
sets and mapping candidates carry over by their fields
(:func:`faultset_to_port`, :func:`candidate_to_port`).

The JAX package's executor takes one float array per layer — conv
``(K, K, C, M)``, FC ``(C_in, C_out)`` — as a ``layer name → ndarray`` dict
or a list aligned with the workload's layers. The port keeps the same
input and hands its kernels each layer as one matrix in the layout the
kernel multiplies by: conv ``(K·K·C, M)`` (the row-major reshape, which
matches an im2col in ``(kr, kc, c)`` order), FC ``(C_in, C_out)``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.mapping import ConvSpec


def weight_shape(layer) -> Tuple[int, ...]:
    """A layer's weights as the JAX package holds them."""
    if isinstance(layer, ConvSpec):
        return (layer.k, layer.k, layer.c_in, layer.c_out)
    return (layer.c_in, layer.c_out)


def kernel_shape(layer) -> Tuple[int, int]:
    """A layer's weights as the port's kernels take them."""
    if isinstance(layer, ConvSpec):
        return (layer.k * layer.k * layer.c_in, layer.c_out)
    return (layer.c_in, layer.c_out)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for a card where there is none
    raises: nothing carries on on the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def _aligned(layers, weights) -> Sequence:
    if isinstance(weights, Mapping):
        names = [l.name for l in layers]
        if len(set(names)) != len(names):
            raise ValueError(
                "workload repeats layer names; pass weights as a "
                "sequence aligned with the layers instead of a dict")
        missing = [n for n in names if n not in weights]
        if missing:
            raise KeyError(f"weights missing for layers {missing}")
        return [weights[n] for n in names]
    seq = list(weights)
    if len(seq) != len(layers):
        raise ValueError(f"{len(seq)} weight arrays for {len(layers)} layers")
    return seq


def host_weights(layers, weights) -> List[np.ndarray]:
    """JAX-package weights (dict or aligned list of arrays) → one float64
    NumPy array per layer in the JAX package's shape, checked."""
    out: List[np.ndarray] = []
    for l, w in zip(layers, _aligned(layers, weights)):
        w = np.asarray(w, dtype=np.float64)
        if w.shape != weight_shape(l):
            raise ValueError(
                f"weights shape {w.shape} != {weight_shape(l)} for {l.name!r}")
        out.append(w)
    return out


def to_port(layers, weights, *, dtype: torch.dtype = torch.float32,
            device=None) -> List[torch.Tensor]:
    """JAX-package weights (dict or aligned list of arrays) → one
    contiguous ``dtype`` tensor per layer in the kernel layout, on
    ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    return [torch.from_numpy(np.ascontiguousarray(w)).reshape(kernel_shape(l))
            .to(device=dev, dtype=dtype).contiguous()
            for l, w in zip(layers, host_weights(layers, weights))]


def from_port(layers, tensors: Sequence[torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's per-layer tensors → the JAX package's ``layer name →
    float64 ndarray`` dict."""
    tensors = list(tensors)
    if len(tensors) != len(layers):
        raise ValueError(f"{len(tensors)} weight tensors for {len(layers)} layers")
    return {
        l.name: t.detach().to("cpu", torch.float64).numpy().reshape(weight_shape(l))
        for l, t in zip(layers, tensors)
    }


def faultset_to_port(fs, arch=None):
    """A fault set of the JAX package (or anything with its fields) → the
    port's :class:`~repro_torch.faults.FaultSet`, field by field. ``arch``
    (the port's ``ArchSpec``; default ``DEFAULT_ARCH``) takes the place of
    the source's, which equality ignores."""
    from repro_torch.core.arch import DEFAULT_ARCH
    from repro_torch.faults import BlockFault, FaultSet, WeightFault

    return FaultSet(
        dead_tiles=tuple(fs.dead_tiles), dead_links=tuple(fs.dead_links),
        dead_chips=tuple(fs.dead_chips), n_chips=fs.n_chips,
        weight_faults=tuple(WeightFault(int(w.layer), int(w.index), str(w.kind))
                            for w in fs.weight_faults),
        cell_rate=float(fs.cell_rate), cell_seed=int(fs.cell_seed),
        dead_blocks=tuple(BlockFault(int(b.layer), int(b.k_index), int(b.c_index),
                                     int(b.m_index)) for b in fs.dead_blocks),
        arch=DEFAULT_ARCH if arch is None else arch)


def candidate_to_port(cand):
    """A mapping candidate of the JAX package (or anything with its fields)
    → the port's :class:`~repro_torch.search.space.MappingCandidate`."""
    from repro_torch.search.space import MappingCandidate

    return MappingCandidate(
        gaps=tuple(int(g) for g in cand.gaps),
        block_c=tuple(int(b) for b in cand.block_c),
        block_m=tuple(int(b) for b in cand.block_m),
        order=tuple(str(o) for o in cand.order),
        egress_rot=tuple(int(r) for r in cand.egress_rot))


def _leaves(tree: Mapping[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def model_params_to_port(cfg, params: Mapping[str, Any], *, cc=None, device=None):
    """A ``repro_torch.models.transformer.Model`` holding the JAX package's
    ``Model.init`` parameters.

    ``params`` is the JAX pytree (nested dicts) with numpy (or array-like)
    leaves; the leaves under ``blocks`` are stacked on a leading axis, one
    entry per block of the port's model (a layer for dense, an
    ``[mLSTM, sLSTM]`` pair, ``num_layers // 2`` of them, for ssm), and go
    to ``blocks.<l>``. Every parameter of the port's model must be given,
    with its exact shape.
    """
    from repro_torch.models.transformer import Model

    model = Model(cfg, cc, device=device)
    n_blocks = len(model.blocks)
    state = {}
    for name, leaf in _leaves(params):
        a = np.asarray(leaf, dtype=np.float32)
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            if a.shape[0] != n_blocks:
                raise ValueError(f"{name} stacks {a.shape[0]} blocks, the config has "
                                 f"{n_blocks}")
            for l in range(n_blocks):
                state[f"blocks.{l}.{rest}"] = torch.tensor(a[l])
        else:
            state[name] = torch.tensor(a)
    own = model.state_dict()
    if set(state) != set(own):
        raise KeyError(f"parameters missing: {sorted(set(own) - set(state))}, "
                       f"unknown: {sorted(set(state) - set(own))}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the model's is "
                             f"{tuple(own[name].shape)}")
    model.load_state_dict(state)
    return model
