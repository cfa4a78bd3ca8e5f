#!/bin/bash
# Runs multi-rank phases of chip_smoke.py from one or more checkouts, in
# the order given, on one card: each argument is TREE:PHASE, PHASE one
# of "fsdp" ("fsdp 4 ranks") or "moe" ("moe 4 ranks"), e.g.
#
#   git archive <parent> | tar -x -C _smoke_checkout/parent
#   scripts/chip_smoke_turns.sh _smoke_checkout/parent:fsdp .:fsdp \
#       .:moe .:fsdp _smoke_checkout/parent:fsdp
#
# to compare a parent and a change in turns on the same card.  Set a
# constant of the parent's copy (FSDP_LAYERS, say) to the change's first
# when the two must run at one depth.  Each tree builds its kernels; each
# line of output is prefixed with its tree and phase.  Exits non-zero
# when a phase failed.
set -o pipefail
rc=0
for arg in "$@"; do
  tree=${arg%%:*}
  phase=${arg##*:}
  (cd "$tree" && python3 - "$phase" <<'PY'
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs
import horovod_tpu_torch as hvd

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs.card_and_power_limit()
cs.log(card)
t0 = time.perf_counter()
hvd.ops.build_kernels()
cs.log(f"build: {time.perf_counter() - t0:.1f} s")
flag, check = {"fsdp": (cs.FSDP_WORKER_FLAG, cs.check_fsdp),
               "moe": (cs.MOE_WORKER_FLAG, cs.check_moe)}[sys.argv[1]]
t0 = time.perf_counter()
cs.parallel_phase(flag, cs.SET_RANKS, check, f"{sys.argv[1]} 4 ranks", card)
cs.log(f"PHASE {sys.argv[1]} {time.perf_counter() - t0:.1f} s")
PY
  ) 2>&1 | sed "s|^|[$tree $phase] |" || rc=1
done
exit $rc
