"""Elastic re-meshing: the plan for recovering from lost nodes by re-sharding
onto a smaller (or grown) mesh from the latest checkpoint.

The port's copy of ``repro.runtime.elastic``'s pure part. Policy: keep the
'model' axis intact (TP size is baked into layer math far less flexibly
than batch), shrink the 'data'/'pod' axes to the largest feasible size, and
rescale grad-accumulation so the GLOBAL batch stays constant (synchronous
semantics preserved across the re-mesh). ``build_mesh`` turns a plan into
a ``DeviceMesh`` over the initialized ``torch.distributed`` world
(``repro_torch.launch.mesh``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.launch.mesh import make_mesh


@dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    pod: int = 0                  # 0 = no pod axis
    accum_multiplier: int = 1     # grad-accum rescale to keep global batch

    @property
    def devices(self) -> int:
        return self.data * self.model * max(self.pod, 1)


def plan_remesh(current: MeshPlan, available_devices: int) -> Optional[MeshPlan]:
    """Largest mesh with the same 'model' size fitting the surviving devices.

    Returns None if even model-parallel degree no longer fits.
    """
    if available_devices < current.model:
        return None
    pods = max(current.pod, 1)
    # shrink pod axis first (whole-pod loss is the common failure unit)
    while pods > 1 and pods * current.model > available_devices:
        pods -= 1
    data = available_devices // (current.model * pods)
    # data axis must divide the old data size for clean accum rescale
    while data > 1 and current.data % data != 0:
        data -= 1
    if data < 1:
        return None
    old_batch_shards = current.data * max(current.pod, 1)
    new_batch_shards = data * pods
    mult = max(1, old_batch_shards // new_batch_shards)
    return MeshPlan(data=data, model=current.model,
                    pod=pods if current.pod else 0,
                    accum_multiplier=current.accum_multiplier * mult)


def build_mesh(plan: MeshPlan, *, device_type: Optional[str] = None):
    """The plan's ``DeviceMesh``: (pod, data, model), or (data, model) with
    no pod axis, over a world of exactly ``plan.devices`` ranks
    (``device_type=None``: the card)."""
    if plan.pod:
        shape, names = (plan.pod, plan.data, plan.model), ("pod", "data", "model")
    else:
        shape, names = (plan.data, plan.model), ("data", "model")
    return make_mesh(shape, names, device_type)
