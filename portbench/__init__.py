"""The benchmark of horovod_tpu_torch on NVIDIA H100 cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the published keys, ``source``,
  ``reduced``, ``assumed`` and the optimizer;
- ``models/<family>.py``: the port's model and loss for a family;
- ``reference/<family>.py``: the plain PyTorch model the port is held to;
- ``traffic/<traffic>.json``: the batch generator's parameters;
- ``workloads/<cell>.json``: the wire, the steps and the limits of
  ``correct``;
- ``metrics/<metric>.py``: one reader a per-layer metric;
- ``work/``: operations and bytes from shapes, and the card's peaks.
"""
