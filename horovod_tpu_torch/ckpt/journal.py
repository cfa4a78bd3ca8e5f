"""Step-metadata journal: replay to the exact failed step, never rewind.

A snapshot cadence of every-K-steps means a crash loses up to K−1 steps
of progress — unless the metadata needed to *re-run* those steps
deterministically is durable at every step.  That metadata is tiny
(step number, RNG key, the elastic sampler's cursor, the autotune knob
snapshot, wall clock), so an append-only fsync'd JSONL line per step is
~free next to the step itself.  Recovery then restores the last full
snapshot and replays journal entries forward to the exact step that
failed: zero lost steps, no silent rewind.

Durability/corruption model (what the tests pin):

* every ``append`` is flushed and fsync'd before returning — a
  journaled step survives a process kill;
* a torn final line (the fsync the crash interrupted) is tolerated:
  reads stop at the last intact line and report the tail as corrupt;
* corruption mid-file also stops the read there (entries past garbage
  can't be trusted to be ordered) — deterministically, with a
  flight-recorder event so the postmortem says the journal was cut;
* re-run steps after an elastic rollback append duplicate step
  numbers; the LAST occurrence wins on replay (it is the one whose
  effects the newest snapshot may contain).

Counterpart of ``horovod_tpu/ckpt/journal.py``: the same line format, so
a journal either package wrote reads the same in the other.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["StepJournal"]


def _jsonable(value: Any):
    """Journal entries carry rng keys / cursors that arrive as arrays;
    the journal is JSON so a human (and ``jq``) can read it mid-incident."""
    if isinstance(value, torch.Generator):
        return value.get_state().tolist()
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    tolist = getattr(value, "tolist", None)
    if callable(tolist):  # a torch tensor
        return tolist()
    return str(value)


class StepJournal:
    """Append-only fsync'd JSONL of per-step metadata.

    One writer (the training loop / ``AsyncCheckpointer.journal_step``),
    many readers (recovery, tests); a lock serializes appends so the
    elastic driver's threads can journal too.
    """

    def __init__(self, path: str, *, fsync: bool = True) -> None:
        self.path = os.path.abspath(path)
        self._fsync = bool(fsync)
        self._lock = threading.Lock()
        self._f = None                      # guarded-by: _lock
        self._corrupt_reported = False      # guarded-by: _lock

    # --- write ---------------------------------------------------------------

    def append(self, step: int, **meta: Any) -> int:
        """Durably append one entry; returns its byte length.  The
        entry is on disk (flushed + fsync'd) when this returns — that
        is the contract replay correctness rests on."""
        entry: Dict[str, Any] = {"step": int(step), "t_unix": time.time()}
        entry.update(meta)
        data = (json.dumps(entry, separators=(",", ":"),
                           default=_jsonable) + "\n").encode()
        with self._lock:
            if self._f is None:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                self._repair_torn_tail_locked()
                self._f = open(self.path, "ab")
            self._f.write(data)
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())
        from ..obs import instrument as _obs

        _obs.on_ckpt_journal(len(data))
        return len(data)

    def _repair_torn_tail_locked(self) -> None:
        """Before the first append of a resumed process: truncate a
        torn final line (the fsync the previous crash interrupted) back
        to the last newline.  Appending onto the partial record would
        merge it with the new entry into one garbage line, and a later
        read would stop THERE — losing every post-restart entry in
        exactly the double-crash scenario the journal exists for.  The
        torn record itself was never acknowledged durable (its append
        never returned), so dropping it loses nothing."""
        try:
            with open(self.path, "rb+") as f:
                raw = f.read()
                if not raw or raw.endswith(b"\n"):
                    return
                cut = raw.rfind(b"\n") + 1
                f.truncate(cut)
        except FileNotFoundError:
            return
        from ..obs import flight as _flight

        _flight.record("ckpt_journal_repaired", path=self.path,
                       dropped_bytes=len(raw) - cut)
        logger.warning(
            "step journal %s: dropped a torn %d-byte tail record "
            "before resuming appends (it was never acknowledged "
            "durable)", self.path, len(raw) - cut)

    # --- read ----------------------------------------------------------------

    def read(self) -> Tuple[List[Dict[str, Any]], bool]:
        """``(entries, intact)`` — entries up to the first damage point,
        ``intact=False`` when a torn/corrupt line cut the read short.
        Missing file reads as ``([], True)``: an empty journal is a
        fresh run, not damage."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return [], True
        entries: List[Dict[str, Any]] = []
        intact = True
        lines = raw.split(b"\n")
        # A properly-terminated file ends with one empty split tail; a
        # torn final fsync leaves a partial line there instead.
        terminated = lines and lines[-1] == b""
        body = lines[:-1] if terminated else lines
        for i, line in enumerate(body):
            if not line.strip():
                continue
            try:
                entry = json.loads(line)
                if not isinstance(entry, dict) or "step" not in entry:
                    raise ValueError("journal line without a step")
            except (ValueError, UnicodeDecodeError):
                intact = False
                self._report_corrupt(i, len(body))
                break
            if not terminated and i == len(body) - 1:
                # Parsed, but the line the crash tore could be a prefix
                # of a longer record that happens to parse — only a
                # newline-terminated line is known complete.
                intact = False
                self._report_corrupt(i, len(body))
                break
            entries.append(entry)
        return entries, intact

    def _report_corrupt(self, line_no: int, total: int) -> None:
        with self._lock:
            first = not self._corrupt_reported
            self._corrupt_reported = True
        from ..obs import flight as _flight

        _flight.record("ckpt_journal_corrupt", path=self.path,
                       line=line_no, lines=total)
        if first:
            logger.warning(
                "step journal %s cut at line %d/%d (torn or corrupt "
                "record); replay stops at the last intact entry",
                self.path, line_no, total)

    def entries_after(self, step: int,
                      entries: Optional[List[Dict[str, Any]]] = None
                      ) -> List[Dict[str, Any]]:
        """Replay tail: intact entries with ``step > step``, dedup'd so
        the LAST occurrence of a step wins (rollback re-runs append
        duplicates), ordered by step.  Pass ``entries`` from an earlier
        :meth:`read` to avoid re-reading an O(run-length) file."""
        if entries is None:
            entries, _ = self.read()
        by_step: Dict[int, Dict[str, Any]] = {}
        for e in entries:
            by_step[int(e["step"])] = e
        return [by_step[s] for s in sorted(by_step) if s > int(step)]

    def last_step(self) -> Optional[int]:
        entries, _ = self.read()
        if not entries:
            return None
        return max(int(e["step"]) for e in entries)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "StepJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
