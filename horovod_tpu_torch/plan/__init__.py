"""MeshPlan: one parallelism planner over the whole world.

Counterpart of ``horovod_tpu/plan/``.  A :class:`MeshPlan` declares the
named axes once (``data``/``fsdp``/``tensor``/``pipe``/``expert``, or
the short ``dp``/``sp``/``tp``/... names) over the ranks, and the rest
derives from it: the optimizer's reduce group, the batch and parameter
specs, one process set and one torch group per axis group, and the
topology tiers.  ``HVD_TPU_MESH_PLAN=data=2,fsdp=2`` sets the session's
plan at ``init``; ``hvd.apply_mesh_plan(spec)`` swaps it.
"""

from .mesh_plan import (  # noqa: F401
    AxisGroup,
    MODEL_AXES,
    MeshPlan,
    P,
    PartitionSpec,
    REDUCE_AXES,
    build_device_mesh,
    collective_groups,
    compile_plan,
    fsdp_param_spec,
    layout_lattice,
    resolve_plan,
    tp_owned_slice,
    tp_param_spec,
    tp_plan,
)
