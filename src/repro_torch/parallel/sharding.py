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
Placing activations and caches inside the LM stack (the reference's
``make_shard_fn`` and ``cache_shardings``) waits for model-parallel
training of the port's LM stack.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

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
        over several axes is split with the first axis outermost, which is
        ``DTensor``'s order only where the axes come in the mesh's order."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        by_axis = {}
        for d, entry in enumerate(self.spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
                raise ValueError(f"spec {self.spec}: dim {d} is split over {axes}, not in the "
                                 f"mesh's axis order {tuple(names)}")
            by_axis.update({a: Shard(d) for a in axes})
        return [by_axis.get(a, Replicate()) for a in names]

    def place(self, x):
        """``x``, whole on every rank, as a ``DTensor`` with these placements."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, self.mesh, self.placements)


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
