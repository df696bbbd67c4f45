"""Weights of the JAX package → the port's tensors, and back.

Two kinds of weights: the executor's per-layer arrays (below), and a
language model's parameter pytree of any of the six families
(:func:`model_params_to_port`). Fault
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


def _stacking(cfg, model) -> Dict[str, Tuple[Tuple[int, ...], ...]]:
    """Where the JAX tree is stacked: a name prefix → for each component of
    the prefix, the stacked axes that follow it (``blocks.<g>.selfs.<i>``
    is ``"blocks.selfs": ((NG,), (ce - 1,))``)."""
    n = (len(model.blocks),)
    if cfg.family == "hybrid":
        return {"blocks": (n + (cfg.hybrid_attn_every,),),
                "tail": ((len(getattr(model, "tail", ())),),)}
    if cfg.family == "vlm":
        return {"blocks.selfs": (n, (cfg.cross_attn_every - 1,)), "blocks.cross": (n, ())}
    return {"blocks": (n,)}


def _port_name(stacking, name: str) -> Tuple[str, Tuple[int, ...]]:
    """A port parameter name -> the JAX tree's dotted name and the index of
    the entry in its stacked axes (``blocks.1.selfs.2.attn.wq`` ->
    ``("blocks.selfs.attn.wq", (1, 2))``; an unstacked name -> ``(name, ())``)."""
    parts = name.split(".")
    for prefix, levels in stacking.items():
        comps, idx, at, ok = prefix.split("."), [], 0, True
        for comp, lvl in zip(comps, levels):
            if at >= len(parts) or parts[at] != comp:
                ok = False
                break
            at += 1
            for _ in lvl:
                if at >= len(parts) or not parts[at].isdigit():
                    ok = False
                    break
                idx.append(int(parts[at]))
                at += 1
            if not ok:
                break
        if ok and at < len(parts):
            return ".".join(comps + parts[at:]), tuple(idx)
    return name, ()


def _unstack(cfg, model, tree: Mapping[str, Any], prepare, cut) -> Dict[str, Any]:
    """``{port name: entry}`` of a reference-layout tree: each leaf's
    ``prepare(name, leaf, stacked shape)`` (the shape ``()`` for a leaf that
    is not stacked, which is its entry), each stacked leaf then cut at every
    index of its stacked axes by ``cut(prepared, index)``."""
    stacking = _stacking(cfg, model)
    out = {}
    for name, leaf in _leaves(tree):
        prefix = next((p for p in stacking if name.startswith(p + ".")), None)
        if prefix is None:
            out[name] = prepare(name, leaf, ())
            continue
        levels = stacking[prefix]
        axes = sum(levels, ())
        leaf = prepare(name, leaf, axes)
        rest = name[len(prefix) + 1:]
        for idx in np.ndindex(*axes):
            parts, it = [], iter(idx)
            for comp, lvl in zip(prefix.split("."), levels):
                parts += [comp, *(str(next(it)) for _ in lvl)]
            out[".".join(parts + [rest])] = cut(leaf, idx)
    return out


def unstack_tree(cfg, model, tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's nested tree shaped like ``Model.init``'s parameters
    (the parameters, or an optimizer moment, whose leaves may be dicts of
    int8 codes and scales) -> ``{port name: array}``, each stacked leaf cut
    at its stacked axes; a leaf nested below a parameter keeps its key as a
    suffix (``blocks.0.attn.wq.q``)."""
    def prepare(name, leaf, axes):
        a = np.asarray(leaf)
        if a.shape[:len(axes)] != axes:
            got, want = a.shape[:len(axes)], axes
            if len(axes) == 1:
                got, want = got[0] if got else None, want[0]
            raise ValueError(f"{name} stacks {got} blocks, the config has {want}")
        return a

    return _unstack(cfg, model, tree, prepare, lambda a, idx: a[idx])


def unstack_axes(cfg, model, axes_tree: Mapping[str, Any]) -> Dict[str, Tuple]:
    """The reference's logical-axes tree (``Model.axes_tree()``: nested
    dicts of tuples of names, a stacked leaf's tuple led by one ``"layers"``
    per stacked axis) -> ``{port name: axes}``, as :func:`unstack_tree`
    cuts the leaves: every entry of a stacked leaf gets its tuple without
    the stacked axes' names."""
    def prepare(name, ax, axes):
        if tuple(ax[:len(axes)]) != ("layers",) * len(axes):
            raise ValueError(f"{name}: axes {ax} do not lead with {len(axes)} stacked axes")
        return tuple(ax)

    return _unstack(cfg, model, axes_tree, prepare, lambda ax, idx: ax[len(idx):])


def stack_tree(cfg, model, flat: Mapping[str, Any], convert=None) -> Dict[str, Any]:
    """The inverse of :func:`unstack_tree`: ``{port name: array}`` -> the
    JAX package's nested tree, each stacked leaf stacked back in index
    order. Tensor entries are stacked as tensors, where they live
    (``torch.stack``); ``convert``, if given, maps each leaf as it is made
    (:func:`repro_torch.train.train_step.state_tree`: a tensor on the card
    to the host), so that a stacked leaf crosses to the host once, already
    stacked, and one stacked leaf at a time stands on the card. A
    ``DTensor`` entry is gathered whole (``full_tensor()``, a collective of
    its mesh) as its stacked leaf is made."""
    stacking = _stacking(cfg, model)
    groups: Dict[str, Dict[Tuple[int, ...], Any]] = {}
    for name, a in flat.items():
        jname, idx = _port_name(stacking, name)
        groups.setdefault(jname, {})[idx] = a if isinstance(a, torch.Tensor) else np.asarray(a)
    tree: Dict[str, Any] = {}
    for jname, entries in groups.items():
        if list(entries) == [()]:
            leaf = _whole(entries[()])
        else:
            order = sorted(entries)
            shape = tuple(1 + max(i[d] for i in order) for d in range(len(order[0])))
            if len(order) != int(np.prod(shape)):
                raise ValueError(f"{jname}: {len(order)} entries do not fill {shape}")
            items = [_whole(entries[i]) for i in order]
            first = items[0]
            stack = torch.stack if isinstance(first, torch.Tensor) else np.stack
            # one entry is stacked as a view of it
            leaf = (first[None] if len(order) == 1 else stack(items)).reshape(
                shape + tuple(first.shape))
        if convert is not None:
            leaf = convert(leaf)
        node = tree
        *path, last = jname.split(".")
        for comp in path:
            node = node.setdefault(comp, {})
        node[last] = leaf
    return tree


def _whole(t):
    """A ``DTensor`` gathered whole; anything else as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def model_params_from_port(model) -> Dict[str, Any]:
    """The inverse of :func:`model_params_to_port`: a port ``Model``'s
    parameters as the JAX package's ``Model.init`` tree (nested dicts of
    float32 numpy arrays, the blocks stacked as ``_stacking`` says)."""
    return stack_tree(model.cfg, model, {
        name: t.detach().to("cpu", torch.float32).numpy()
        for name, t in model.state_dict().items()})


def model_params_to_port(cfg, params: Mapping[str, Any], *, cc=None, device=None):
    """A ``repro_torch.models.transformer.Model`` holding the JAX package's
    ``Model.init`` parameters.

    ``params`` is the JAX pytree (nested dicts) with numpy (or array-like)
    leaves (:func:`model_params_from_port` is the inverse). The leaves under ``blocks`` are stacked on a leading axis, one
    entry per block of the port's model (a layer for dense, audio and moe
    every layer, a ``{dense, moe_l}`` group for moe every other layer, an
    ``[mLSTM, sLSTM]`` pair for ssm), and go to ``blocks.<l>``; the hybrid
    family's ``blocks`` are stacked on two, ``(NG, ke)``, and go to
    ``blocks.<g>.<i>``, its ``tail`` on one (``tail.<r>``), and its
    ``shared_attn`` is not stacked. The vlm family's stacking differs per
    subtree: ``blocks.selfs`` on ``(NG, ce - 1)`` → ``blocks.<g>.selfs.<i>``,
    ``blocks.cross`` on ``(NG,)`` → ``blocks.<g>.cross``. The audio tables
    ``(K, V, D)`` are not stacked. Every parameter of the port's model must
    be given, with its exact shape.
    """
    from repro_torch.models.transformer import Model

    model = Model(cfg, cc, device=device)
    state = {name: torch.tensor(np.asarray(a, dtype=np.float32))
             for name, a in unstack_tree(cfg, model, params).items()}
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
