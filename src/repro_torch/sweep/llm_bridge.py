"""Bridge from the repo's LLM ArchConfigs to Domino FC-layer networks.

The PyTorch port's own copy of ``repro.sweep.llm_bridge``.

Opens the sweep to every seed config in ``repro_torch.configs``: a transformer
decode step is, from the NoC's point of view, a chain of matrix-vector
products — exactly the FC systolic-column dataflow Domino already models
(paper §III). Each projection becomes one ``FCSpec``; MoE layers contribute
only their routed (top-k) experts. This is an analytic workload generator
for design-space exploration, not a functional LLM: attention score/value
math and normalizations are out of scope of the CIM-array event model.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.mapping import FCSpec


def fc_network_from_config(cfg: ArchConfig) -> Tuple[FCSpec, ...]:
    """Per-token matmul chain of one decode step as Domino FC layers."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kvd = cfg.num_kv_heads * cfg.head_dim
    n_ffn_mats = 3 if cfg.activation in ("silu", "swiglu") else 2
    layers: List[FCSpec] = []
    for i in range(cfg.num_layers):
        pre = f"{cfg.name}.l{i}"
        layers += [
            FCSpec(f"{pre}.q", d, d),
            FCSpec(f"{pre}.k", d, kvd),
            FCSpec(f"{pre}.v", d, kvd),
            FCSpec(f"{pre}.o", d, d),
        ]
        if f > 0:
            moe_here = cfg.moe is not None and (i % cfg.moe.moe_every == 0)
            n_experts = cfg.moe.top_k if moe_here else 1
            for e in range(n_experts):
                tag = f".e{e}" if n_experts > 1 else ""
                if n_ffn_mats == 3:
                    layers.append(FCSpec(f"{pre}{tag}.gate", d, f))
                layers += [FCSpec(f"{pre}{tag}.up", d, f),
                           FCSpec(f"{pre}{tag}.down", f, d)]
    layers.append(FCSpec(f"{cfg.name}.head", d, v))
    return tuple(layers)
