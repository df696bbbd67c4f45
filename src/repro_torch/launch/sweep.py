"""Design-space sweep through the port's batched engine.

The port's counterpart of the JAX package's ``benchmarks/sweep.py``.
Evaluates a grid of scenarios (network x chip count x precision x CIM-array
energy x architecture axes x dataflow) on one or both backends
(``--backend torch|numpy|both``; ``torch``, the default, runs the float64
column math on the card, or on ``--device``), cross-checks every Tab. IV
column against per-scenario ``DominoModel.evaluate`` (1e-9 for the NumPy
oracle, 1e-6 for a lone torch run) and — when both backends run — torch
against the NumPy oracle (1e-6), and emits JSON with each backend's
``engine_wall_s`` and its ``build_wall_s`` (the batch build) part.

Default grid: 4 networks x 4 chip counts x 2 precisions x 2 e_mac points
= 64 scenarios. ``--perf`` swaps in a >=1e5-scenario grid that sweeps the
`ArchSpec` axes (tiles/chip, n_c x n_m geometry, node) for backend timing;
``--smoke-1e6`` a >=1e6-scenario grid evaluated in chunks.

    PYTHONPATH=src python -m repro_torch.launch.sweep --out sweep.json
    PYTHONPATH=src python -m repro_torch.launch.sweep --backend both --perf \\
        --no-check --out sweep-perf.json
    PYTHONPATH=src python -m repro_torch.launch.sweep --device cpu --chips 5 10
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch.core.mapping import NETWORKS
from repro_torch.dataflows import REGISTRY_VERSION
from repro_torch.sweep import COLUMNS, SweepGrid, SweepValidationError, run_sweep
from repro_torch.sweep.engine import evaluate_scenario
from repro_torch.sweep.scenario import AXES, Scenario

# substituted CIM energy points (pJ / 8b OP at 45nm/1V): the span of the
# Tab. IV counterparts' implied e_mac (repro_torch.launch.table_iv)
DEFAULT_E_MAC_PJ = (0.02, 0.1)
DEFAULT_CHIPS = (5, 6, 10, 20)
DEFAULT_PRECISIONS = (8, 16)

# torch-vs-numpy agreement bound: the JAX package's float64 kernel bound
# (tests/test_sweep_backends.py), which the torch backend takes over
TORCH_RTOL = 1e-6


def default_grid() -> SweepGrid:
    return SweepGrid(
        networks=tuple(NETWORKS),
        chip_counts=DEFAULT_CHIPS,
        precisions=DEFAULT_PRECISIONS,
        e_mac_pj=DEFAULT_E_MAC_PJ,
    )


def perf_grid() -> SweepGrid:
    """>=1e5 scenarios, sweeping the ArchSpec axes (geometry pareto)."""
    return SweepGrid(
        networks=tuple(NETWORKS),
        chip_counts=(1, 2, 4, 5, 8, 10, 20, 40),
        precisions=(8, 16),
        e_mac_pj=tuple(round(0.01 * (1.2 ** i), 8) for i in range(32)),
        tiles_per_chip=(180, 240, 300),
        n_c=(128, 256, 512),
        n_m=(128, 256, 512),
        node_nm=(45.0, 22.0),
    )


def smoke_1e6_grid() -> SweepGrid:
    """>=1e6 scenarios: the perf grid with a dense CIM-energy axis
    (4 x 8 x 2 x 290 x 3 x 3 x 3 x 2 = 1,002,240). The chunked-execution
    case (``--smoke-1e6``)."""
    return SweepGrid(
        networks=tuple(NETWORKS),
        chip_counts=(1, 2, 4, 5, 8, 10, 20, 40),
        precisions=(8, 16),
        e_mac_pj=tuple(round(0.01 * (1.05 ** i), 10) for i in range(290)),
        tiles_per_chip=(180, 240, 300),
        n_c=(128, 256, 512),
        n_m=(128, 256, 512),
        node_nm=(45.0, 22.0),
    )


def check_against_scalar(result, rtol: float = 1e-9, indices=None) -> float:
    """Max relative error of the batched engine vs the scalar oracle, over
    every scenario or over ``indices`` (flat scenario numbers)."""
    worst = 0.0
    for i in (range(result.n_scenarios) if indices is None else indices):
        s = _scenario_at(result.grid, int(i))
        ref = evaluate_scenario(s)
        for c in COLUMNS:
            got, want = float(result.columns[c][i]), float(ref[c])
            err = abs(got - want) / max(abs(want), 1e-300)
            worst = max(worst, err)
            if err > rtol:
                raise AssertionError(
                    f"batched/scalar mismatch on {c} for {s}: "
                    f"{got!r} vs {want!r} (rel err {err:.3e})"
                )
    return worst


def _scenario_at(grid: SweepGrid, i: int):
    """The ``i``-th scenario of ``grid.scenarios()`` without building the
    whole list (row-major over ``AXES``)."""
    idx = np.unravel_index(i, grid.shape)
    n, c, p, e, t, nc, nm, node, df = (getattr(grid, a)[k] for a, k in zip(AXES, idx))
    return Scenario(network=n, n_chips=c, precision_bits=int(p), e_mac_pj=float(e),
                    tiles_per_chip=int(t), n_c=int(nc), n_m=int(nm),
                    node_nm=float(node), dataflow=df)


def check_backends_agree(ref, other, rtol: float = TORCH_RTOL) -> float:
    """Max relative error between two backends' columns (NumPy = oracle)."""
    worst = 0.0
    for c in COLUMNS:
        a, b = other.columns[c], ref.columns[c]
        err = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
        worst = max(worst, err)
        if err > rtol:
            raise AssertionError(
                f"backend mismatch on column {c}: "
                f"{other.backend} vs {ref.backend} rel err {err:.3e}"
            )
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--networks", nargs="*", default=None,
                    help="network names (default: the four Tab. IV CNNs)")
    ap.add_argument("--chips", nargs="*", type=int, default=None,
                    help=f"chip counts (default: {list(DEFAULT_CHIPS)})")
    ap.add_argument("--precisions", nargs="*", type=int, default=None,
                    help=f"bit-widths (default: {list(DEFAULT_PRECISIONS)})")
    ap.add_argument("--e-mac", nargs="*", type=float, default=None,
                    help=f"CIM pJ/OP points (default: {list(DEFAULT_E_MAC_PJ)})")
    ap.add_argument("--tiles-per-chip", nargs="*", type=int, default=None,
                    help="ArchSpec axis: tiles per chip (default: 240)")
    ap.add_argument("--n-c", nargs="*", type=int, default=None,
                    help="ArchSpec axis: CIM array rows (default: 256)")
    ap.add_argument("--n-m", nargs="*", type=int, default=None,
                    help="ArchSpec axis: CIM array cols (default: 256)")
    ap.add_argument("--node-nm", nargs="*", type=float, default=None,
                    help="ArchSpec axis: technology node nm (default: 45)")
    ap.add_argument("--dataflow", nargs="*", default=None,
                    help="dataflow axis: registered model names (default: "
                         "com; e.g. --dataflow com minimal_buffer sweeps "
                         "the head-to-head)")
    ap.add_argument("--backend", choices=("torch", "numpy", "both"),
                    default="torch", help="evaluation backend(s) to run")
    ap.add_argument("--device", default=None,
                    help="the torch backend's device (default: the card; "
                         "'cpu' runs it on the CPU)")
    ap.add_argument("--perf", action="store_true",
                    help="use the >=1e5-scenario ArchSpec-axes perf grid")
    ap.add_argument("--smoke-1e6", action="store_true",
                    help="use the >=1e6-scenario chunked-execution smoke "
                         "grid (implies --no-check; chunk_size defaults to "
                         "65536)")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="evaluate in bounded-memory chunks of this many "
                         "scenarios (records peak_chunk_bytes in the "
                         "artifact)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing repetitions per backend (best-of; warms "
                         "the summary caches)")
    ap.add_argument("--out", default=None,
                    help="write JSON here (default: stdout)")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the per-scenario scalar cross-check")
    args = ap.parse_args(argv)

    if args.smoke_1e6:
        base = smoke_1e6_grid()
        args.no_check = True       # 1e6 scalar oracle walks are pointless
        if args.chunk_size is None:
            args.chunk_size = 65536
    else:
        base = perf_grid() if args.perf else default_grid()
    try:
        grid = SweepGrid(
            networks=tuple(args.networks) if args.networks else base.networks,
            chip_counts=tuple(args.chips) if args.chips else base.chip_counts,
            precisions=tuple(args.precisions) if args.precisions else base.precisions,
            e_mac_pj=tuple(args.e_mac) if args.e_mac else base.e_mac_pj,
            tiles_per_chip=(tuple(args.tiles_per_chip) if args.tiles_per_chip
                            else base.tiles_per_chip),
            n_c=tuple(args.n_c) if args.n_c else base.n_c,
            n_m=tuple(args.n_m) if args.n_m else base.n_m,
            node_nm=tuple(args.node_nm) if args.node_nm else base.node_nm,
            dataflow=tuple(args.dataflow) if args.dataflow else base.dataflow,
        )
    except SweepValidationError as e:
        ap.error(str(e))

    backends = ("numpy", "torch") if args.backend == "both" else (args.backend,)
    results = {}
    for backend in backends:
        best = None
        for _ in range(max(args.repeats, 1)):
            r = run_sweep(grid, backend=backend, chunk_size=args.chunk_size,
                          device=args.device if backend == "torch" else None)
            if best is None or r.engine_wall_s < best.engine_wall_s:
                best = r
        results[backend] = best

    oracle = results.get("numpy") or results[backends[0]]
    payload = oracle.as_dict()
    payload["dataflow_models"] = list(grid.dataflow)
    payload["dataflow_registry_version"] = REGISTRY_VERSION
    payload["backends"] = {
        b: dict(engine_wall_s=r.engine_wall_s, build_wall_s=r.build_wall_s,
                scenarios_per_s=grid.n_scenarios / max(r.engine_wall_s, 1e-12))
        for b, r in results.items()
    }
    if "torch" in results:
        import torch

        from repro_torch.convert import resolve_device

        dev = resolve_device(args.device)
        payload["torch_device"] = (torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else str(dev))
    if "numpy" in results and "torch" in results:
        payload["torch_max_rel_err_vs_numpy"] = check_backends_agree(
            results["numpy"], results["torch"])
    if not args.no_check:
        t1 = time.perf_counter()
        # the NumPy backend is held to the 1e-9 oracle contract; a lone
        # torch run is checked at its 1e-6 (device FMA / division)
        rtol = 1e-9 if oracle.backend == "numpy" else TORCH_RTOL
        payload["check_max_rel_err"] = check_against_scalar(oracle, rtol=rtol)
        payload["check_wall_s"] = time.perf_counter() - t1

    # headline summary for humans on stderr (JSON stays machine-readable)
    ce = oracle.columns["ce_tops_w"]
    wall_line = ", ".join(
        f"{b}: {payload['backends'][b]['engine_wall_s'] * 1e3:.1f} ms"
        for b in backends
    )
    print(
        f"swept {oracle.n_scenarios} scenarios ({wall_line}); "
        f"CE {np.min(ce):.2f}-{np.max(ce):.2f} TOPS/W"
        + ("" if args.no_check
           else f"; batched==scalar (max rel err {payload['check_max_rel_err']:.2e})"),
        file=sys.stderr,
    )

    text = json.dumps(payload, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
