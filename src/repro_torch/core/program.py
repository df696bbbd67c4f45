"""Workload → CompiledProgram: the compile entry point of the port.

The PyTorch port's own copy of ``repro.core.program`` for the greedy
mapping on a pristine fabric. The IR is the same:

* :class:`Workload` — a frozen, named DNN layer graph (an immutable
  sequence of ``ConvSpec``/``FCSpec``; the network constructors
  ``vgg16_imagenet()`` etc. return one).
* :func:`compile_program` — greedy tile placement, the explicit
  ``ceil(C/n_c) × ceil(M/n_m)`` block partition of every layer, the
  per-tile periodic instruction schedules and the closed-form per-image
  event counts, memoized on the hashable ``(workload, arch)`` pair.
* :class:`CompiledProgram` / :class:`LayerProgram` / :class:`LayerBlock` —
  the compiled artifact; ``CompiledProgram.executor()`` runs it image →
  logits (:mod:`repro_torch.core.executor`).

The searched mapping (``repro.search``) and compilation around a fault set
(``repro.faults``) are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Iterator, List, Mapping, Tuple, Union

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.core.mapping import ConvSpec, FCSpec, TileAlloc, greedy_place, total_chips
from repro_torch.core.schedule import TileSchedule, layer_schedules
from repro_torch.core.simulator import EVENT_FIELDS, batched_layer_events, layer_table

LayerSpec = Union[ConvSpec, FCSpec]


@dataclass(frozen=True)
class Workload:
    """A frozen, named DNN layer graph — the input of :func:`compile_program`.

    Behaves as an immutable *sequence* of layer specs (``len``, iteration,
    indexing). Equality and hash ignore the display ``name`` and key on
    the layer tuple alone, so two workloads with identical layers share
    one compile cache line.
    """

    name: str = field(compare=False)
    layers: Tuple[LayerSpec, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "layers", tuple(self.layers))
        if not self.layers:
            raise ValueError("a Workload must contain at least one layer")
        problems: List[str] = []
        for i, l in enumerate(self.layers):
            if not isinstance(l, (ConvSpec, FCSpec)):
                problems.append(f"layers[{i}] is not a ConvSpec/FCSpec: {l!r}")
        if problems:
            raise ValueError(f"invalid Workload {self.name!r}:\n" + "\n".join(problems))

    @classmethod
    def of(cls, layers, name: str = "workload") -> "Workload":
        """Normalize: pass a ``Workload`` through, wrap a layer sequence."""
        if isinstance(layers, Workload):
            return layers
        return cls(name, tuple(layers))

    def __len__(self) -> int:
        return len(self.layers)

    def __iter__(self) -> Iterator[LayerSpec]:
        return iter(self.layers)

    def __getitem__(self, i):
        return self.layers[i]


@dataclass(frozen=True)
class LayerBlock:
    """One ``(c_index, m_index)`` channel slice of a layer's block grid.

    ``spec`` is the sliced layer spec this block's CIM array actually holds
    (``c_in = c_range`` width, ``c_out = m_range`` width); ``roles`` are
    the keys into the owning :class:`LayerProgram`'s ``schedules`` dict
    that this block's tiles execute. Only the *last* C-block of an M-chain
    carries the M-type role (activation fires once per output slice, after
    the partial-sum chain closes).
    """

    layer_name: str
    c_index: int
    m_index: int
    c_range: Tuple[int, int]       # [start, stop) input-channel slice
    m_range: Tuple[int, int]       # [start, stop) output-channel slice
    spec: LayerSpec
    roles: Tuple[str, ...]
    n_tiles: int                   # K² for conv blocks, 1 for FC blocks
    is_last_c: bool = False        # closes the partial-sum chain (fires ACT)


@dataclass(frozen=True, eq=False)
class LayerProgram:
    """One layer, compiled: allocation + block chain + schedules + events.

    ``blocks`` is row-major over ``(c_index, m_index)``; ``events`` are the
    closed-form per-image event counts; ``schedules`` resolves lazily
    through the memoized ``layer_schedules(layer, arch)`` cache.
    """

    layer: LayerSpec
    arch: ArchSpec
    alloc: TileAlloc
    c_blocks: int
    m_blocks: int
    blocks: Tuple[LayerBlock, ...]
    events: Mapping[str, int]

    @property
    def schedules(self) -> Mapping[str, TileSchedule]:
        return layer_schedules(self.layer, self.arch)

    def block(self, c_index: int, m_index: int) -> LayerBlock:
        return self.blocks[c_index * self.m_blocks + m_index]

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)


@dataclass(frozen=True, eq=False)
class CompiledProgram:
    """The compiled artifact of one ``(workload, arch)`` pair."""

    workload: Workload
    arch: ArchSpec
    layer_programs: Tuple[LayerProgram, ...]
    allocs: Tuple[TileAlloc, ...]
    event_totals: Mapping[str, int]

    @property
    def n_tiles(self) -> int:
        return sum(a.n_tiles for a in self.allocs)

    @property
    def n_chips(self) -> int:
        return total_chips(list(self.allocs))

    def layer_program(self, name: str) -> LayerProgram:
        matches = [lp for lp in self.layer_programs if lp.layer.name == name]
        if not matches:
            raise KeyError(
                f"no layer {name!r} in workload {self.workload.name!r}; "
                f"known: {[lp.layer.name for lp in self.layer_programs]}"
            )
        if len(matches) > 1:
            raise KeyError(
                f"layer name {name!r} is ambiguous in workload "
                f"{self.workload.name!r} ({len(matches)} layers share it); "
                f"index layer_programs positionally instead"
            )
        return matches[0]

    def executor(self, weights, *, backend: str = "cuda", device=None):
        """A :class:`~repro_torch.core.executor.ProgramExecutor` over this
        program: runs the whole layer chain image→logits, batched over a
        leading image axis, through the CUDA ``com_matmul`` kernel
        (``backend="cuda"``, the default) or the float64 block-chain
        reference (``backend="reference"``). ``device=None`` means the
        card; pass ``device="cpu"`` to run the reference on the CPU."""
        from repro_torch.core.executor import ProgramExecutor

        return ProgramExecutor(self, weights, backend=backend, device=device)

    def execute(self, images, weights, *, backend: str = "cuda", device=None):
        """One-shot whole-program run: build an executor and run the batch.
        Returns an :class:`~repro_torch.core.executor.ExecutionResult`."""
        return self.executor(weights, backend=backend, device=device).run(images)


def _blocks_for(layer: LayerSpec, arch: ArchSpec) -> Tuple[int, int, Tuple[LayerBlock, ...]]:
    """The explicit block grid of one layer: channel ranges + schedule roles."""
    n_c, n_m = arch.n_c, arch.n_m
    cb, mb = arch.block_partition(layer.c_in, layer.c_out)
    k2 = layer.k * layer.k if isinstance(layer, ConvSpec) else 1
    blocks: List[LayerBlock] = []
    for ci in range(cb):
        cs, ce = ci * n_c, min((ci + 1) * n_c, layer.c_in)
        for mi in range(mb):
            ms, me = mi * n_m, min((mi + 1) * n_m, layer.c_out)
            spec = dataclasses.replace(
                layer, name=f"{layer.name}[c{ci}m{mi}]",
                c_in=ce - cs, c_out=me - ms,
            )
            if isinstance(layer, ConvSpec):
                roles = tuple(f"k{i}" for i in range(k2))
                if ci == cb - 1:
                    roles += ("mtype_last",)
            else:
                roles = (f"r{ci}",)
            blocks.append(LayerBlock(
                layer_name=layer.name, c_index=ci, m_index=mi,
                c_range=(cs, ce), m_range=(ms, me), spec=spec,
                roles=roles, n_tiles=k2, is_last_c=ci == cb - 1,
            ))
    return cb, mb, tuple(blocks)


# Bounded: each CompiledProgram holds block grids for every layer; 256
# covers the Tab. IV networks across many architectures, and an eviction
# only costs a recompile.
@lru_cache(maxsize=256)
def _compile_program(workload: Workload, arch: ArchSpec) -> CompiledProgram:
    layers = workload.layers
    allocs = tuple(greedy_place(list(layers), arch))
    per_layer_events = batched_layer_events(layer_table(layers), arch)
    programs: List[LayerProgram] = []
    for i, (layer, alloc) in enumerate(zip(layers, allocs)):
        cb, mb, blocks = _blocks_for(layer, arch)
        programs.append(LayerProgram(
            layer=layer, arch=arch, alloc=alloc, c_blocks=cb, m_blocks=mb,
            blocks=blocks,
            events={f: int(per_layer_events[f][i]) for f in EVENT_FIELDS},
        ))
    return CompiledProgram(
        workload=workload, arch=arch, layer_programs=tuple(programs),
        allocs=allocs,
        event_totals={f: int(per_layer_events[f].sum()) for f in EVENT_FIELDS},
    )


def compile_program(workload, arch: ArchSpec = DEFAULT_ARCH,
                    mapping="greedy", faults=None) -> CompiledProgram:
    """Compile a workload for an architecture — the port's entry point.

    One call derives tile placement (``CompiledProgram.allocs``), the
    per-layer block partition (``LayerProgram.blocks``), the per-tile
    instruction schedules (``LayerProgram.schedules``) and the closed-form
    per-image event counts (``CompiledProgram.event_totals``), equal to
    what ``repro.core.program.compile_program`` gives for the same
    workload and architecture.

    Only ``mapping="greedy"`` on a pristine fabric is ported: a searched
    mapping or a mapping candidate, and a non-empty ``faults`` set, raise
    ``NotImplementedError`` rather than silently compiling greedy.
    """
    if faults is not None:
        raise NotImplementedError(
            "compile_program(faults=...) is not ported yet: fault-aware "
            "placement (repro.faults) comes in a later slice of the port")
    if isinstance(mapping, str) and mapping == "greedy":
        return _compile_program(Workload.of(workload), arch)
    if mapping == "searched" or not isinstance(mapping, str):
        raise NotImplementedError(
            f"compile_program(mapping={mapping!r}) is not ported yet: the "
            "mapping search (repro.search) comes in a later slice of the port")
    raise ValueError(
        f"unknown mapping {mapping!r}; expected 'greedy' (the only mapping "
        "the port compiles so far)")
