"""The serving fleet tier.

Counterpart of ``horovod_tpu/serve/fleet``.  This slice of the port
holds the global prefix directory (:mod:`.directory`), which the
router's prefix affinity reads.  Role-split replicas with live KV
migration, the fleet controller and the simulator are the next serving
slice (ROADMAP.md, queue A item 4).
"""

from .directory import PrefixDirectory  # noqa: F401
