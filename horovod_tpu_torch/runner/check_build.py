"""``--check-build``: the port's feature matrix (reference: ``horovodrun
--check-build``, counterpart of ``horovod_tpu/runner/check_build.py``).

It reports what this installation really has: torch and its CUDA,
NCCL and gloo, nvcc; whether each of the four kernel libraries is built
for the sources as they stand (``ops/_build.py`` keys them by hash; the
check builds none of them); and the native control-plane runtime, which
it builds with g++ if needed (seconds), with its ABI version and the
route each of its consumers takes.
"""

from __future__ import annotations


def _mark(ok: bool) -> str:
    return "X" if ok else " "


def _kernel_lines() -> list:
    from ..ops import _build

    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        nvcc = None
    lines = [f"    [{_mark(nvcc is not None)}] nvcc "
             f"{nvcc or 'not found (the kernels cannot be built here)'}"]
    for name in _build.SOURCES:
        path = _build.library_path(name)
        built = path.exists()
        lines.append(f"    [{_mark(built)}] csrc/{name}.cu: "
                     + (f"built ({path.name})" if built
                        else "not built (nvcc builds it at first use)"))
    return lines


def _native_lines() -> list:
    from ..native import bindings, build

    abi = bindings.abi_version()
    if abi is None:
        err = (build.last_error or "load failed").splitlines()[0]
        return [
            "    [ ] native runtime not built: " + err,
            "        route: Python (fusion and schedule planners, "
            "timeline writer); no cross-process stall monitor",
        ]
    return [
        f"    [X] native runtime built (ABI {abi}, "
        f"{build.library_path().name}): controller, coordinator, fusion "
        "and schedule planners, response cache, group table, stall "
        "inspector, timeline writer",
        "        route: native (planners under "
        "HVD_TPU_USE_NATIVE_PLANNER=1, the timeline's writer thread, the "
        "cross-process monitor under HVD_TPU_NATIVE_COORD=1)",
    ]


def check_build_str() -> str:
    import torch
    import torch.distributed as dist

    from ..version import __version__

    cuda = torch.version.cuda
    nccl = dist.is_available() and dist.is_nccl_available()
    nccl_version = ""
    if nccl and cuda:
        try:
            nccl_version = " " + ".".join(
                map(str, torch.cuda.nccl.version()[:3]))
        except Exception:
            nccl_version = ""
    lines = [
        f"horovod_tpu_torch v{__version__}",
        "",
        "Available frameworks:",
        f"    [X] pytorch {torch.__version__} "
        f"(CUDA {cuda or 'none: CPU build'})",
        "",
        "Available controllers:",
        "    [X] torch.distributed (torchrun's env rendezvous)",
        f"    [{_mark(nccl and cuda is not None)}] NCCL{nccl_version}",
        f"    [{_mark(dist.is_available() and dist.is_gloo_available())}]"
        " gloo",
        f"    [{_mark(dist.is_available() and dist.is_mpi_available())}]"
        " MPI",
        "",
        "Kernels (hand-written for sm_90a, horovod_tpu_torch/csrc):",
        *_kernel_lines(),
        "",
        "Native control plane (horovod_tpu_torch/native/src, g++):",
        *_native_lines(),
        "",
        "Runtime features:",
        "    [X] timeline (HOROVOD_TIMELINE Chrome trace) and stall "
        "inspectors (per process and cross-process)",
        "    [X] observability core (metrics, traces, flight recorder, "
        "Prometheus export; MetricsRequest/TraceRequest over the HMAC "
        "control plane)",
        "    [X] durable state (async sharded checkpoints, journal, "
        "elastic recovery, fault injection)",
        "",
        "Launchers:",
        "    [X] local multi-process (-np N, torchrun's variables)",
        "    [X] elastic (--host-discovery-script, min/max-np)",
        "    [ ] multi-host (-H/--hostfile naming other hosts, LSF): not "
        "ported yet",
    ]
    return "\n".join(lines)
