"""The native (C++) control-plane runtime, loaded through ctypes.

Counterpart of ``horovod_tpu/native``: the port's own copy of its
framework-neutral C++ (``src/``), built with g++ at first use into
``horovod_tpu_torch/_build/`` (``build.py``), with the same C ABI
(``bindings.py``, ``ABI_VERSION`` 3).  The control plane only: tensor
bytes never cross this boundary.

* ``planner.cc`` — fusion bucket, two-phase and two-tier schedule
  planners (:mod:`.planner`)
* ``wire.{h,cc}`` — the Request/Response wire format
* ``tensor_queue.h`` — framework to coordinator handoff queue
* ``controller.{h,cc}``, ``response_cache.h``, ``group_table.h`` —
  rank-0 consensus and fusion
* ``stall_inspector.h`` — some-but-not-all-ranks stall tracking
* ``timeline.{h,cc}`` — background-thread Chrome-trace writer
* ``coordinator.{h,cc}`` — the TCP negotiation service
* ``c_api.cc`` — the plain-C ABI

Fail-soft, as the reference: without g++ every consumer takes its
Python path (the build logs a warning with the compiler's error, and
``python -m horovod_tpu_torch.runner --check-build`` says which route is
active).
"""

from . import bindings  # noqa: F401
from . import planner  # noqa: F401
from .runtime import (  # noqa: F401
    Controller, Coordinator, NativeStallInspector, NativeTensorQueue,
    NativeTimeline, NativeUnavailableError, Request, Response, available,
    encode_requests, decode_requests, encode_responses, decode_responses,
)
