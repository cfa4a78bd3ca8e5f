"""The disaggregated prefill/decode serving fleet.

Counterpart of ``horovod_tpu/serve/fleet``: prefill is compute-bound,
decode is memory-bound, so the fleet splits them onto separate replica
classes:

* **roles + live KV migration** (:mod:`.migration`) — replicas declare
  ``prefill`` / ``decode`` / ``unified``; a prefill replica runs the
  prompt, then streams the resulting paged KV blocks to a decode
  replica over the HMAC ``BasicService`` wire, the slot's block table
  as the transfer manifest and per-block sha256 digests verifying the
  transfer — the decode replica binds the blocks into its own pool and
  continues generation token-identically.
* **global prefix directory** (:mod:`.directory`) — leading block keys
  → replicas with resident blocks, so a system-prompt hit anywhere in
  the fleet routes to resident KV.
* **elastic autoscaling** (:mod:`.controller`) — per-role replica
  counts driven by queue-depth/TTFT signals: scale out the saturated
  role, drain-and-retire when idle; it also rolls weight swaps over the
  fleet (``roll_swap``, ``rollback``).

``serve/router.py`` owns the role-aware dispatch
(admit→prefill→migrate→decode pipeline); this package owns the data
handoff, the directory and the control loop.  The fleet simulator
(``sim.py``, ``sim_replica.py``, ``traces.py``) is the next slice of the
port (ROADMAP.md, queue A).
"""

from .controller import FleetController, ReplicaLauncher, ROLES  # noqa: F401
from .directory import PrefixDirectory  # noqa: F401
from .migration import (  # noqa: F401
    MigrationBuffer, MigrationError, block_digests, migrate_slot,
    shard_digests, verify_digests, verify_shard_digests,
)
