"""Workload → CompiledProgram: the compile entry point of the port.

The PyTorch port's own copy of ``repro.core.program``. The IR is the same:

* :class:`Workload` — a frozen, named DNN layer graph (an immutable
  sequence of ``ConvSpec``/``FCSpec``; the network constructors
  ``vgg16_imagenet()`` etc. return one).
* :func:`compile_program` — tile placement (greedy, greedy around a
  :class:`~repro_torch.faults.FaultSet`, a searched mapping or a given
  :class:`~repro_torch.search.space.MappingCandidate`), the explicit block
  partition of every layer, the per-tile periodic instruction schedules
  and the closed-form per-image event counts, memoized on the hashable
  ``(workload, arch[, candidate][, faults])`` key.
* :class:`CompiledProgram` / :class:`LayerProgram` / :class:`LayerBlock` —
  the compiled artifact; ``CompiledProgram.executor()`` runs it image →
  logits (:mod:`repro_torch.core.executor`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Iterator, List, Mapping, Tuple, Union

import numpy as np

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
    # how the placement/blocking was chosen: "greedy" (the default compile
    # path) or "searched" (repro_torch.search); a searched program carries
    # the realized MappingCandidate
    mapping: str = "greedy"
    candidate: object = None
    # the FaultSet the placement degraded around (None = pristine fabric);
    # the executor also reads it as the default for weight-fault injection
    faults: object = None

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

    def executor(self, weights, *, backend: str = "cuda", device=None, faults=None):
        """A :class:`~repro_torch.core.executor.ProgramExecutor` over this
        program: runs the whole layer chain image→logits, batched over a
        leading image axis, through the CUDA ``com_matmul`` kernel
        (``backend="cuda"``, the default) or the float64 block-chain
        reference (``backend="reference"``). ``device=None`` means the
        card; pass ``device="cpu"`` to run the reference on the CPU.
        ``faults=None`` executes the program's own FaultSet."""
        from repro_torch.core.executor import ProgramExecutor

        return ProgramExecutor(self, weights, backend=backend, device=device,
                               faults=faults)

    def execute(self, images, weights, *, backend: str = "cuda", device=None,
                faults=None):
        """One-shot whole-program run: build an executor and run the batch.
        Returns an :class:`~repro_torch.core.executor.ExecutionResult`."""
        return self.executor(weights, backend=backend, device=device,
                             faults=faults).run(images)


def _blocks_for(layer: LayerSpec, arch: ArchSpec,
                n_c: int = 0, n_m: int = 0) -> Tuple[int, int, Tuple[LayerBlock, ...]]:
    """The explicit block grid of one layer: channel ranges + schedule roles.

    ``n_c``/``n_m`` override the architecture's full-array blocking with a
    candidate mapping's per-layer block sizes (0 = use ``arch``, the
    committed partition).
    """
    if n_c or n_m:
        n_c, n_m = n_c or arch.n_c, n_m or arch.n_m
        cb, mb = -(-layer.c_in // n_c), -(-layer.c_out // n_m)
    else:
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


def _assemble(workload: Workload, arch: ArchSpec, allocs, blocking=None,
              **provenance) -> CompiledProgram:
    """A CompiledProgram from a placement: block grids, per-layer and total
    events. ``blocking`` is a candidate's per-layer ``(block_c, block_m)``
    (None: the arch's full-array partition); ``provenance`` fills
    ``mapping``/``candidate``/``faults``."""
    layers = workload.layers
    if blocking is None:
        per_layer_events = batched_layer_events(layer_table(layers), arch)
        sizes = [(0, 0)] * len(layers)
    else:
        block_c, block_m = blocking
        per_layer_events = batched_layer_events(
            layer_table(layers), arch,
            n_c_eff=np.asarray(block_c, dtype=np.int64),
            n_m_eff=np.asarray(block_m, dtype=np.int64))
        sizes = list(zip(block_c, block_m))
    programs: List[LayerProgram] = []
    for i, (layer, alloc, (n_c, n_m)) in enumerate(zip(layers, allocs, sizes)):
        cb, mb, blocks = _blocks_for(layer, arch, n_c=n_c, n_m=n_m)
        programs.append(LayerProgram(
            layer=layer, arch=arch, alloc=alloc, c_blocks=cb, m_blocks=mb,
            blocks=blocks,
            events={f: int(per_layer_events[f][i]) for f in EVENT_FIELDS},
        ))
    return CompiledProgram(
        workload=workload, arch=arch, layer_programs=tuple(programs),
        allocs=tuple(allocs),
        event_totals={f: int(per_layer_events[f].sum()) for f in EVENT_FIELDS},
        **provenance,
    )


# Bounded: each CompiledProgram holds block grids for every layer; 256
# covers the Tab. IV networks across many architectures, and an eviction
# only costs a recompile.
@lru_cache(maxsize=256)
def _compile_program(workload: Workload, arch: ArchSpec) -> CompiledProgram:
    return _assemble(workload, arch, greedy_place(list(workload.layers), arch))


# Bounded and separate from _compile_program: fault experiments (yield
# sweeps compile many FaultSets) must never evict the pristine lines. The
# per-layer events are the pristine closed forms (they depend on layers and
# arch, not on which chips the tiles landed on); what a FaultSet changes is
# the placement itself, which the off-chip cost model prices.
@lru_cache(maxsize=64)
def _compile_program_faulted(workload: Workload, arch: ArchSpec,
                             faults) -> CompiledProgram:
    allocs = greedy_place(list(workload.layers), arch, faults=faults)
    return _assemble(workload, arch, allocs, faults=faults)


# Bounded like _compile_program; a separate cache so search experiments
# never evict the greedy lines every consumer shares.
@lru_cache(maxsize=64)
def _compile_candidate(workload: Workload, arch: ArchSpec,
                       candidate) -> CompiledProgram:
    from repro_torch.search.space import candidate_allocs, validate_candidate

    validate_candidate(workload.layers, arch, candidate)
    allocs, _starts = candidate_allocs(workload.layers, arch, candidate)
    return _assemble(workload, arch, allocs, (candidate.block_c, candidate.block_m),
                     mapping="searched", candidate=candidate)


def compile_program(workload, arch: ArchSpec = DEFAULT_ARCH,
                    mapping="greedy", faults=None) -> CompiledProgram:
    """Compile a workload for an architecture — the port's entry point.

    One call derives tile placement (``CompiledProgram.allocs``), the
    per-layer block partition (``LayerProgram.blocks``), the per-tile
    instruction schedules (``LayerProgram.schedules``) and the closed-form
    per-image event counts (``CompiledProgram.event_totals``), equal to
    what ``repro.core.program.compile_program`` gives for the same
    arguments.

    ``mapping`` selects how placement/blocking is chosen:

    * ``"greedy"`` (default) — ``mapping.greedy_place`` and the full-array
      block partition;
    * ``"searched"`` — ``repro_torch.search.search_mapping(workload,
      arch)`` optimizes the mapping first (default budget, engine, seed and
      backend; run ``search_mapping`` yourself for others) and the program
      realizes the winning candidate;
    * a :class:`repro_torch.search.space.MappingCandidate` — realize that
      candidate (validated; raises ``ValueError`` if illegal).

    ``faults`` (a :class:`repro_torch.faults.FaultSet`) compiles around a
    degraded fabric with the greedy walk: dead tiles/links/chips are
    skipped, layers spill to spare chips, and a bounded fleet that cannot
    hold the workload raises :class:`repro_torch.faults.FaultCapacityError`.
    ``FaultSet.empty()`` and ``None`` give the same cached pristine
    program. A non-empty FaultSet with another mapping than ``"greedy"``
    raises ``ValueError``.

    Memoized on the frozen key; ``workload`` may be a :class:`Workload` or
    any layer sequence (wrapped via :meth:`Workload.of`).
    """
    wl = Workload.of(workload)
    if faults is not None and not faults.is_empty:
        if mapping != "greedy":
            raise ValueError(
                f"compile_program(faults=...) re-places with the greedy "
                f"walk; mapping={mapping!r} is not supported with a "
                "non-empty FaultSet (validate candidates against faults "
                "with repro_torch.search.space.validate_candidate instead)")
        return _compile_program_faulted(wl, arch, faults)
    if isinstance(mapping, str):
        if mapping == "greedy":
            return _compile_program(wl, arch)
        if mapping == "searched":
            from repro_torch.search import search_mapping

            return _compile_candidate(
                wl, arch, search_mapping(wl, arch).candidate)
        raise ValueError(
            f"unknown mapping {mapping!r}; expected 'greedy', 'searched', "
            f"or a repro_torch.search.space.MappingCandidate")
    from repro_torch.search.space import MappingCandidate

    if isinstance(mapping, MappingCandidate):
        return _compile_candidate(wl, arch, mapping)
    raise ValueError(
        f"unknown mapping {mapping!r}; expected 'greedy', 'searched', "
        f"or a repro_torch.search.space.MappingCandidate")
