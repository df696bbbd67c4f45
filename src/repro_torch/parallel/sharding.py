"""Logical-axis sharding: declarative rules -> shardings on a mesh.

The port's copy of the parts of ``repro.parallel.sharding`` that data- and
pod-parallel training and the elastic restore need. ``ShardingRules`` maps
logical names to mesh axes with a divisibility fallback (a dim that does
not divide the mesh axis product is replicated and the drop is recorded —
e.g. minicpm's prime-ish vocab 122753).

A spec is a tuple with one entry per tensor dim: None, a mesh-axis name,
or a tuple of names (the reference's ``PartitionSpec``, as a tuple). A
:class:`Sharding` is a spec on a mesh; its ``placements`` are the
``DTensor`` placements of a ``DeviceMesh``, and ``place`` distributes a
tensor with them.

Two rule vocabularies (never mixed):
  params:      embed / mlp / heads / kv / vocab / experts / layers
  activations: batch / seq / embed(act) / vocab(act) / kv_seq / ...

Mesh axes: ("data", "model") single pod, ("pod", "data", "model")
multi-pod (``repro_torch.launch.mesh``). FSDP = param "embed" over
data(+pod); TP = mlp/heads/vocab over model; EP = experts over model.

Model-parallel training of the LM stack (the dense, audio, vlm and moe
families) runs on ``DTensor``: :func:`place_params` places each parameter
by :func:`param_rules` over ``Model.axes_tree()`` (audio's codebook tables
``(None, "vocab", "embed")``, the experts over "model" or, at ``ep_split >
1``, their slices over the whole mesh), :func:`make_shard_fn` is
``CallConfig.shard_fn`` (it redistributes an activation to its logical
axes' spec at the reference's call sites, the moe dispatch's buffers
among them), and :func:`batch_shardings` places the batch and the vlm
image embeddings. :func:`cache_shardings` gives the reference's specs of
every family's cache leaves (the port's cache is a flat tuple; the
reference's key path of each leaf picks its axes); nothing runs a sharded
cache yet, as the reference lowers one only in its dry run.

``DTensor`` redistributes with functional collectives (all-gather,
reduce-scatter, all-reduce, all-to-all). A ``gloo`` group of ranks that
share one card takes them on device tensors, all but the all-gather, which
ends the process; ``torch.distributed.all_gather_into_tensor`` of the same
tensor returns (``scripts/gloo_cuda_probe.py``).
:class:`GlooDeviceCollectives` routes the functional all-gather of a device
tensor in a ``gloo`` group through that call; :func:`device_collectives`
enters it where a mesh needs it, chosen by the mesh's device type and its
groups' backend. :class:`CommCounter`
counts the collectives and their bytes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import mesh_shape

PyTree = Any


def _axis_size(shape: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: the port's ``NamedSharding``."""

    mesh: Any
    spec: Tuple

    @property
    def placements(self) -> list:
        """One ``DTensor`` placement per mesh axis: ``Shard(d)`` where the
        spec puts the axis on tensor dim ``d``, else ``Replicate()``. A dim
        over several axes is split in the mesh's axis order, the only order
        ``DTensor`` has, whatever the spec's: "experts_ep" lists "model"
        first, so the ranks hold the expert-parallel slices in another
        order than the reference's devices do. The values are the same, and
        a buffer split by the same spec lines up with the weights."""
        names = list(self.mesh.mesh_dim_names)
        by_axis = {}
        for d, entry in enumerate(self.spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            by_axis.update({a: Shard(d) for a in axes})
        return [by_axis.get(a, Replicate()) for a in names]

    def place(self, x):
        """``x``, whole and the same on every rank, as a ``DTensor`` with
        these placements: each rank keeps its own chunk of its own copy
        (``src_data_rank=None``), so nothing crosses the group."""
        return distribute_tensor(x, self.mesh, self.placements, src_data_rank=None)


@dataclass
class ShardingRules:
    """Logical-name -> mesh-axis mapping for one job kind."""

    rules: Dict[str, Any]
    mesh: Any
    dropped: List[str] = field(default_factory=list)

    def spec_for(self, logical_axes: Tuple, shape: Tuple[int, ...]) -> Tuple:
        if len(logical_axes) != len(shape):
            raise ValueError(f"logical axes {logical_axes} for a shape {shape}")
        sizes = mesh_shape(self.mesh)
        out = []
        used: set = set()
        for name, dim in zip(logical_axes, shape):
            axes = self.rules.get(name) if name is not None else None
            if axes is None:
                out.append(None)
                continue
            ax_t = (axes,) if isinstance(axes, str) else tuple(axes)
            ax_t = tuple(a for a in ax_t if a in sizes and a not in used)
            size = _axis_size(sizes, ax_t)
            if not ax_t or size <= 1 or dim % size != 0:
                # divisibility fallback: try prefix subsets
                while ax_t and (dim % _axis_size(sizes, ax_t) != 0):
                    ax_t = ax_t[:-1]
                if not ax_t:
                    self.dropped.append(f"{name}:{dim}")
                    out.append(None)
                    continue
            used.update(ax_t)
            out.append(ax_t[0] if len(ax_t) == 1 else ax_t)
        return tuple(out)

    def named(self, logical_axes: Tuple, shape: Tuple[int, ...]) -> Sharding:
        return Sharding(self.mesh, self.spec_for(logical_axes, shape))

    def tree_shardings(self, axes_tree: PyTree, shape_tree: PyTree) -> PyTree:
        """axes_tree leaves are tuples of logical names; shape_tree leaves
        are tensors or arrays of matching rank (extra *leading* dims in the
        shape — layer-stack dims — are padded with None). Trees are nested
        dicts and lists."""

        def go(ax, leaf):
            if isinstance(ax, dict):
                return {k: go(ax[k], leaf[k]) for k in ax}
            if isinstance(ax, list) or (isinstance(ax, tuple) and not _is_axes(ax)):
                return type(ax)(go(a, l) for a, l in zip(ax, leaf))
            shape = tuple(leaf.shape)
            ax = tuple(ax)
            if len(ax) < len(shape):
                ax = (None,) * (len(shape) - len(ax)) + ax
            return self.named(ax, shape)

        return go(axes_tree, shape_tree)


def mesh_size(mesh) -> int:
    """The number of ranks of ``mesh``."""
    return math.prod(mesh_shape(mesh).values())


def _is_axes(t: tuple) -> bool:
    return all(isinstance(x, (str, type(None))) for x in t)


# ---------------------------------------------------------------------------
# Rule sets
# ---------------------------------------------------------------------------


def param_rules(mesh) -> ShardingRules:
    fsdp = ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)
    return ShardingRules(
        rules={
            "embed": fsdp,
            "mlp": "model",
            "heads": "model",
            "kv": "model",
            "vocab": "model",
            "experts": "model",
            # token-routing EP: expert slices over the FULL mesh (weights
            # stationary; 'embed'/'mlp' on those leaves fall back to None
            # via the used-axes rule)
            "experts_ep": ("model",) + fsdp,
            "layers": None,
        },
        mesh=mesh,
    )


def act_rules(mesh, *, job: str = "train", seq_shard: bool = False) -> ShardingRules:
    batch = ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)
    rules = {
        "batch": batch,
        "seq": "model" if seq_shard else None,
        "embed": None,
        "vocab": "model",
        # KV cache: sequence over model. Decode => LSE-combined attention
        # (flash-decoding); prefill => the cache *write* is seq-sharded
        # (attention itself runs on the fresh k/v, not the cache).
        "kv_seq": "model" if job in ("decode", "prefill") else None,
        "kv_heads": None,
        "ssm_heads": "model",
        "ssm_conv": "model",
        # MoE dispatch: dp groups over batch axes, expert buffer over model
        "exp_dp": batch,
        "experts": "model",
        "experts_ep": ("model",) + tuple(batch if isinstance(batch, tuple) else (batch,)),
    }
    return ShardingRules(rules=rules, mesh=mesh)


def leading_axis_sharding(mesh, ndim: int = 1, axis: str = "data") -> Sharding:
    """A :class:`Sharding` that partitions only the leading tensor axis:
    the one spec the data-parallel scale-out paths need (the sharded sweep
    backend splits its flat per-scenario arrays this way)."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def batch_shardings(rules: ShardingRules, batch_tree: PyTree) -> PyTree:
    """Inputs: tokens/targets (B,S[,K]) + optional image_embeds (B,T,D),
    a dict (or nested dicts) of tensors or arrays."""
    if isinstance(batch_tree, dict):
        return {k: batch_shardings(rules, v) for k, v in batch_tree.items()}
    rank = len(batch_tree.shape)
    return rules.named(("batch",) + (None,) * (rank - 1), tuple(batch_tree.shape))


def make_shard_fn(mesh, rules: ShardingRules):
    """Returns ``CallConfig.shard_fn``: ``shard(x, logical_axes)`` is the
    ``DTensor`` ``x`` redistributed to the placements of
    ``rules.spec_for(logical_axes, x.shape)`` on ``mesh``. A plain tensor is
    returned as it is where ``mesh`` has one rank; on a larger mesh it
    raises, since the model would then be running a plain tensor where the
    mesh needs a ``DTensor``. The function carries ``mesh`` and ``rules``
    (``shard.mesh``, ``shard.rules``), which the model reads to place its
    batch."""
    n = mesh_size(mesh)

    def shard(x, logical_axes):
        if not isinstance(x, DTensor):
            if n == 1:
                return x
            raise TypeError(f"shard_fn got a plain tensor of shape {tuple(x.shape)} on a mesh "
                            f"of {n} ranks; place the parameters (place_params) and the batch")
        spec = rules.spec_for(tuple(logical_axes), tuple(x.shape))
        return x.redistribute(mesh, Sharding(mesh, spec).placements)

    shard.mesh, shard.rules = mesh, rules
    return shard


def place_params(model, mesh, rules: ShardingRules = None, *, axes=None):
    """Swap every parameter of ``model`` for a ``DTensor`` parameter on
    ``mesh``, placed by ``rules`` (default :func:`param_rules`) over its
    logical axes: the counterpart of the reference's ``jax.device_put`` over
    ``tree_shardings(axes_tree(), params)``. ``axes`` is a nested dict of
    axes shaped like the module's parameter names (a ``Block``'s
    ``block_axes(cfg)``); by default the port's ``Model``'s own,
    ``model.axes_tree()`` cut per layer (``convert.unstack_axes``). Every
    rank holds the same weights (drawn from one seed, or converted), so each
    keeps a copy of its own chunk (``src_data_rank=None``) and nothing is
    scattered. The mesh must be on the parameters' device type. Returns
    ``model``."""
    from repro_torch.convert import _leaves, unstack_axes

    rules = param_rules(mesh) if rules is None else rules
    axes = (unstack_axes(model.cfg, model, model.axes_tree()) if axes is None
            else dict(_leaves(axes)))
    for name, p in list(model.named_parameters()):
        if isinstance(p, DTensor):
            raise ValueError(f"{name} is placed already")
        if p.device.type != mesh.device_type:
            raise ValueError(f"{name} lives on {p.device}; the mesh is over "
                             f"{mesh.device_type!r} ranks")
        sharding = rules.named(axes[name], tuple(p.shape))
        # a copy of the chunk, so that the whole parameter can be freed
        local = sharding.place(p.detach()).to_local().clone()
        placed = DTensor.from_local(local, mesh, sharding.placements, run_check=False,
                                    shape=p.shape, stride=p.stride())
        owner, leaf = name.rsplit(".", 1)
        model.get_submodule(owner)[leaf] = torch.nn.Parameter(placed,
                                                              requires_grad=p.requires_grad)
    return model


# ---------------------------------------------------------------------------
# Cache sharding (the reference's heuristic over each leaf's key path)
# ---------------------------------------------------------------------------


def _cache_axes(path: str, rank: int) -> Tuple:
    """The reference's ``cache_shardings`` axes of the leaf at ``path`` (its
    ``jax.tree_util.keystr``) with ``rank`` dims."""
    if "cross" in path:
        ax = ("batch", None, "kv_heads", None)
    elif "conv" in path:
        ax = ("batch", None, "ssm_conv")
    elif "ssd" in path:
        ax = ("batch", "ssm_heads", None, None)
    elif "mlstm" in path:
        ax = {4: ("batch", None, None, None), 3: ("batch", None, None),
              2: ("batch", None)}[min(rank, 4)]
    elif "slstm" in path:
        ax = ("batch", None, None)
    else:  # self-attention K/V (B, S, KVH, hd)
        ax = ("batch", "kv_seq", "kv_heads", None)
    while len(ax) > rank:
        ax = ax[1:]
    return (None,) * (rank - len(ax)) + tuple(ax)


def cache_shardings(rules: ShardingRules, cache, cfg) -> tuple:
    """A :class:`Sharding` for each leaf of the port's flat ``cache`` tuple
    (``Model.init_cache``'s, or any leaves of its shapes) of an ``cfg``
    model: the reference's path heuristic over its stacked cache pytree,
    each leaf matched to the reference's key path
    (:func:`repro_torch.models.transformer.cache_paths`)."""
    from repro_torch.models.transformer import cache_paths

    paths = cache_paths(cfg)
    if len(paths) != len(cache):
        raise ValueError(f"a {cfg.family} cache has {len(paths)} leaves, got {len(cache)}")
    return tuple(rules.named(_cache_axes(p, len(leaf.shape)), tuple(leaf.shape))
                 for p, leaf in zip(paths, cache))


# ---------------------------------------------------------------------------
# gloo's device collectives, and counting the collectives
# ---------------------------------------------------------------------------


class GlooDeviceCollectives(TorchDispatchMode):
    """A dispatch mode under which ``DTensor``'s functional all-gather
    (``all_gather_into_tensor``) of a tensor on one of ``devices`` in a
    ``gloo`` group runs as ``torch.distributed.all_gather_into_tensor``,
    which gloo takes on device memory; every other op, and the all-gather
    in any other group or on any other device, runs as it is. The returned
    tensor is complete, so the functional ``wait_tensor`` that follows has
    nothing to wait for. ``routed`` counts the calls routed."""

    def __init__(self, devices=("cuda",)):
        super().__init__()
        self.devices = tuple(devices)
        self.routed = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is DTensor for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.all_gather_into_tensor.default:
            x, size, name = tuple(args) + tuple(kwargs[a.name]
                                                for a in func._schema.arguments[len(args):])
            group = dist.distributed_c10d._resolve_process_group(name)
            if x.device.type in self.devices and dist.get_backend(group) == "gloo":
                self.routed += 1
                out = x.new_empty((x.shape[0] * size,) + tuple(x.shape[1:]))
                dist.all_gather_into_tensor(out, x.contiguous(), group=group)
                return out
        return func(*args, **kwargs)


def device_collectives(mesh):
    """:class:`GlooDeviceCollectives` for a mesh of CUDA ranks whose groups
    are ``gloo``'s (ranks that share a card); a context that changes
    nothing for any other mesh, or none."""
    import contextlib

    if mesh is None or mesh.device_type != "cuda" or not all(
            dist.get_backend(mesh.get_group(i)) == "gloo" for i in range(mesh.ndim)):
        return contextlib.nullcontext()
    return GlooDeviceCollectives()



class CommCounter(TorchDispatchMode):
    """A dispatch mode that counts the collectives run under it, ``DTensor``'s
    redistributions (functional collectives) and direct ``torch.distributed``
    calls alike: ``counts[name] = {"calls", "bytes"}``, ``bytes`` the
    bytes of the calls' inputs on this rank, and ``shapes[name]`` the set of
    their input shapes."""

    OUTPUT_FIRST = ("_allgather_base_", "_reduce_scatter_base_", "alltoall_base_",
                    "allgather_into_tensor_coalesced_", "reduce_scatter_tensor_coalesced_")

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, Dict[str, int]] = {}
        self.shapes: Dict[str, set] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if func.namespace == "c10d" or (func.namespace == "_c10d_functional"
                                        and not name.startswith("_") and "wait" not in name):
            # c10d's base ops take (output, input, ...); the rest the input first
            first = args[1] if name in self.OUTPUT_FIRST else args[0]
            tensors = [t for t in (first if isinstance(first, (list, tuple)) else [first])
                       if isinstance(t, torch.Tensor)]
            c = self.counts.setdefault(name, {"calls": 0, "bytes": 0})
            c["calls"] += 1
            c["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
            self.shapes.setdefault(name, set()).update(tuple(t.shape) for t in tensors)
        return out
