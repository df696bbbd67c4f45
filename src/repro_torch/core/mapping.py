"""Layer -> tile mapping (paper §III) and chip partitioning.

The PyTorch port's own copy of the pristine-fabric part of
``repro.core.mapping``: the same layer specs, the same greedy walk and the
same Tab. IV network constructors, so both packages compile a workload to
equal integers.

CONV K x K x C x M  ->  K² x ceil(C/Nc) x ceil(M/Nm) tiles (kernel pixels
unrolled ACROSS tiles, in row-major kernel order — the COM pipeline order).
FC C_in x C_out     ->  ceil(C_in/Nc) x ceil(C_out/Nm) tiles (systolic
column accumulation).

Chips hold ``tiles_per_chip`` tiles (240 in the paper's evaluation, CIM
arrays of 256 x 256); layers are placed greedily in network order and a
layer spanning a chip boundary contributes its IFM/OFM traffic to the
off-chip accounting (paper §IV-B3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.search.space import validate_allocs


@dataclass(frozen=True)
class ConvSpec:
    name: str
    k: int           # filter size K
    c_in: int
    c_out: int
    h_in: int        # input feature map height
    w_in: int        # width
    stride: int = 1
    padding: int = 1
    pool_k: int = 0   # pooling after this layer (K_p); 0 = none
    pool_stride: int = 2
    residual_from: Optional[str] = None  # ResNet skip source

    @property
    def h_out(self) -> int:
        return (self.h_in + 2 * self.padding - self.k) // self.stride + 1

    @property
    def w_out(self) -> int:
        return (self.w_in + 2 * self.padding - self.k) // self.stride + 1

    @property
    def macs(self) -> int:
        return self.h_out * self.w_out * self.k * self.k * self.c_in * self.c_out

    @property
    def ops(self) -> int:
        return 2 * self.macs


@dataclass(frozen=True)
class FCSpec:
    name: str
    c_in: int
    c_out: int

    @property
    def macs(self) -> int:
        return self.c_in * self.c_out

    @property
    def ops(self) -> int:
        return 2 * self.macs


LayerSpec = "ConvSpec | FCSpec"


@dataclass(frozen=True)
class TileAlloc:
    """Immutable: instances are shared through the compile cache."""

    layer: LayerSpec
    n_tiles: int
    grid: Tuple[int, int, int]      # (K², c_blocks, m_blocks) — conv
    chip_ids: Tuple[int, ...] = ()
    crosses_chip: bool = False


def tiles_for(layer, arch: ArchSpec = DEFAULT_ARCH) -> Tuple[int, Tuple[int, int, int]]:
    cb, mb = arch.block_partition(layer.c_in, layer.c_out)
    if isinstance(layer, ConvSpec):
        return layer.k * layer.k * cb * mb, (layer.k * layer.k, cb, mb)
    return cb * mb, (1, cb, mb)


def greedy_place(layers: List, arch: ArchSpec = DEFAULT_ARCH) -> List[TileAlloc]:
    """Greedy in-order placement pass; per-layer allocations w/ chip ids.

    This is the placement *algorithm*; ``repro_torch.core.program
    .compile_program`` is the public entry point that runs (and caches) it
    as part of building a ``CompiledProgram``. Placement on a degraded
    fabric (the JAX package's ``faults=``) is not ported yet.
    """
    tiles_per_chip = arch.tiles_per_chip
    allocs: List[TileAlloc] = []
    chip, used = 0, 0
    for layer in layers:
        n, grid = tiles_for(layer, arch)
        chips: List[int] = []
        left = n
        start_chip = chip
        while left > 0:
            take = min(left, tiles_per_chip - used)
            if take == 0:
                chip += 1
                used = 0
                continue
            chips.append(chip)
            used += take
            left -= take
        allocs.append(
            TileAlloc(layer=layer, n_tiles=n, grid=grid, chip_ids=tuple(chips),
                      crosses_chip=len(set(chips)) > 1 or chips[0] != start_chip)
        )
    # a capacity overflow or span inconsistency becomes a ValueError
    # instead of a silent mis-mapping
    validate_allocs(allocs, arch)
    return allocs


def total_chips(allocs: List[TileAlloc]) -> int:
    return max(c for a in allocs for c in a.chip_ids) + 1


# ---------------------------------------------------------------------------
# Prevailing CNNs from the paper's evaluation (Tab. IV)
# ---------------------------------------------------------------------------


def _workload(name: str, layers: List) -> "Workload":  # noqa: F821
    # late import: repro_torch.core.program imports this module at load time
    from repro_torch.core.program import Workload

    return Workload(name, tuple(layers))


def _vgg(cfg: List, h: int, w: int, fc: List[Tuple[int, int]], name: str):
    layers: List = []
    c_in = 3
    for v in cfg:
        if v == "M":
            # pooling is fused into the preceding conv layer (paper Fig. 4)
            prev = layers[-1]
            layers[-1] = ConvSpec(**{**prev.__dict__, "pool_k": 2})
            h, w = h // 2, w // 2
            continue
        layers.append(ConvSpec(f"{name}.conv{len(layers)}", 3, c_in, v, h, w))
        c_in = v
    for j, (ci, co) in enumerate(fc):
        layers.append(FCSpec(f"{name}.fc{j}", ci, co))
    return layers


def vgg11_cifar() -> "Workload":  # noqa: F821
    return _workload(
        "vgg11-cifar",
        _vgg([64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
             32, 32, [(512, 4096), (4096, 4096), (4096, 10)], "vgg11"))


def vgg16_imagenet() -> "Workload":  # noqa: F821
    return _workload(
        "vgg16-imagenet",
        _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
             224, 224, [(512 * 7 * 7, 4096), (4096, 4096), (4096, 1000)], "vgg16"))


def vgg19_imagenet() -> "Workload":  # noqa: F821
    return _workload(
        "vgg19-imagenet",
        _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
             224, 224, [(512 * 7 * 7, 4096), (4096, 4096), (4096, 1000)], "vgg19"))


def resnet18_cifar() -> "Workload":  # noqa: F821
    """ResNet-18 (CIFAR-10 variant, paper Tab. IV col. [17])."""
    layers: List = [ConvSpec("rn.conv0", 3, 3, 64, 32, 32)]
    h = w = 32
    c = 64
    blockcfg = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]
    for co, nblocks, stride0 in blockcfg:
        for b in range(nblocks):
            s = stride0 if b == 0 else 1
            layers.append(ConvSpec(f"rn.c{co}b{b}a", 3, c, co, h, w, stride=s))
            h, w = layers[-1].h_out, layers[-1].w_out
            layers.append(
                ConvSpec(f"rn.c{co}b{b}b", 3, co, co, h, w,
                         residual_from=f"rn.c{co}b{b}a")  # skip via RIFM shortcut
            )
            c = co
    layers.append(FCSpec("rn.fc", 512, 10))
    return _workload("resnet18-cifar", layers)


NETWORKS = {
    "vgg11-cifar": vgg11_cifar,
    "vgg16-imagenet": vgg16_imagenet,
    "vgg19-imagenet": vgg19_imagenet,
    "resnet18-cifar": resnet18_cifar,
}
