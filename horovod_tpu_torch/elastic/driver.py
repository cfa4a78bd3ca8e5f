"""Elastic driver: host discovery polling, membership tracking,
blacklisting, worker notification.

Reference: ``horovod/runner/elastic/driver.py`` + ``discovery.py`` +
``registration.py`` (SURVEY.md §2.5, mount empty, unverified): a driver
polls ``--host-discovery-script``, maintains the host set, starts/stops
workers as slots appear/fail, blacklists repeatedly-failing hosts, and
pings workers through a WorkerNotificationService when membership
changes.

TPU-native notes: slice membership is managed by the platform
(GKE/queued resources re-provision slices); this driver is the
*control-plane* equivalent for self-managed fleets — it polls discovery,
detects membership deltas, and invokes callbacks that typically raise
``HostsUpdatedInterrupt`` inside workers or restart the
``jax.distributed`` world via the runner.
"""

from __future__ import annotations

import logging
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from .. import faults as faults_mod
from ..obs import instrument as _obs
from ..utils.retry import RetryPolicy, retry_call
from .state import HostsUpdatedInterrupt

logger = logging.getLogger(__name__)


class HostDiscovery:
    """Interface (reference: ``HostDiscovery``): return the current
    ``{host: slots}`` mapping."""

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        raise NotImplementedError


class ScriptDiscovery(HostDiscovery):
    """Reference: ``HostDiscoveryScript`` — run a user script that prints
    ``hostname:slots`` per line (the ``--host-discovery-script``
    contract).

    One script run is allowed to flake: invocations ride the shared
    retry helper (jittered exponential backoff, ``retries`` attempts)
    so a transient non-zero exit or timeout doesn't surface as a
    membership event.  Persistent failure propagates — the driver's
    consecutive-failure accounting decides when that means the
    membership is gone.
    """

    def __init__(self, script: str, timeout_s: float = 30.0,
                 retries: int = 3, backoff_s: float = 0.5) -> None:
        self.script = script
        self.timeout_s = timeout_s
        self._policy = RetryPolicy(attempts=max(1, retries),
                                   base_delay_s=backoff_s,
                                   max_delay_s=max(backoff_s, 5.0))

    def _run_script(self) -> str:
        if faults_mod._active is not None:
            faults_mod.on_discovery_script(self.script)
        return subprocess.run(
            self.script, shell=True, capture_output=True, text=True,
            timeout=self.timeout_s, check=True,
        ).stdout

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = retry_call(
            self._run_script,
            policy=self._policy,
            retry_on=(subprocess.SubprocessError, OSError),
            describe=f"host discovery ({self.script})",
        )
        hosts: Dict[str, int] = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                host, slots = line.rsplit(":", 1)
                hosts[host] = int(slots)
            else:
                hosts[line] = 1
        if faults_mod._active is not None:
            hosts = faults_mod.on_discovery_hosts(hosts)
        return hosts


class FixedDiscovery(HostDiscovery):
    """Static host set (tests / non-elastic fallback)."""

    def __init__(self, hosts: Dict[str, int]) -> None:
        self.hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self.hosts)


class ElasticDriver:
    """Membership tracker (reference: ``ElasticDriver``).

    ``on_hosts_updated`` callbacks receive ``(added, removed)`` host
    sets.  Hosts that fail more than ``blacklist_after`` times are
    excluded from membership (reference: host blacklisting) — but not
    forever: after ``blacklist_decay_s`` the host gets a half-open
    probation (strikes drop to ``blacklist_after - 1``, so one more
    failure re-blacklists immediately, one success via
    :meth:`record_success` clears it).  Permanent blacklists turn every
    transient rack drain into permanently-lost capacity at fleet scale.

    Discovery itself is allowed to fail: ``poll_once`` counts
    *consecutive* failures and treats membership as unknown-but-
    unchanged until ``failure_threshold`` in a row, at which point the
    host set is declared lost (``{}``) and callbacks fire — a dead
    discovery endpoint is indistinguishable from a dead fleet, and
    waiting forever on a stale host set is the worse failure mode.
    """

    def __init__(self, discovery: HostDiscovery, *,
                 poll_interval_s: float = 1.0,
                 blacklist_after: int = 3,
                 blacklist_decay_s: Optional[float] = None,
                 failure_threshold: Optional[int] = None) -> None:
        from .. import basics
        from ..config import Config

        # The resolved Config when this process init()ed; the same
        # parser over the env in launcher/supervisor processes.
        cfg = basics.config() if basics.is_initialized() \
            else Config.from_env()
        self.discovery = discovery
        self.poll_interval_s = poll_interval_s
        self.blacklist_after = blacklist_after
        self.blacklist_decay_s = (
            blacklist_decay_s if blacklist_decay_s is not None
            else cfg.blacklist_decay_seconds)
        self.failure_threshold = (
            failure_threshold if failure_threshold is not None
            else cfg.discovery_failure_threshold)
        self._hosts: Dict[str, int] = {}         # guarded-by: _lock
        self._failures: Dict[str, int] = {}      # guarded-by: _lock
        self._blacklist: Dict[str, float] = {}   # guarded-by: _lock (host -> blacklisted-at)
        self._reserved: Dict[str, int] = {}      # guarded-by: _lock (host -> placed replicas)
        self._poll_failures = 0                  # guarded-by: _lock (consecutive discovery errors)
        self._callbacks: List[Callable[[Set[str], Set[str]], None]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        from ..analysis import sanitizer as _san

        _san.maybe_register("elastic_slots", self)

    # --- membership --------------------------------------------------------

    @property
    def hosts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hosts)

    def world_size(self) -> int:
        return sum(self.hosts.values())

    def register_hosts_updated_callback(self, cb) -> None:
        self._callbacks.append(cb)

    def record_failure(self, host: str) -> None:
        """Reference: failed workers increment their host's strike count;
        over the limit → blacklist (time-stamped, so decay can age it)."""
        with self._lock:
            self._failures[host] = self._failures.get(host, 0) + 1
            if self._failures[host] >= self.blacklist_after:
                if host not in self._blacklist:
                    logger.warning("Blacklisting host %s after %d failures"
                                   " (decay: %s)",
                                   host, self._failures[host],
                                   f"{self.blacklist_decay_s:.0f}s"
                                   if self.blacklist_decay_s > 0
                                   else "never")
                    _obs.on_blacklist("blacklisted")
                self._blacklist[host] = time.monotonic()

    def record_success(self, host: str) -> None:
        """A host completed useful work: reset its strikes and lift any
        blacklist — the half-open probation closes on the good side."""
        with self._lock:
            had = self._failures.pop(host, 0)
            lifted = self._blacklist.pop(host, None) is not None
        if lifted or had:
            if lifted:
                _obs.on_blacklist("cleared")
            logger.info("Host %s recovered (strikes reset%s)", host,
                        ", blacklist lifted" if lifted else "")

    def _blacklisted_locked(self, host: str) -> bool:
        """Caller holds the lock.  Applies decay as a side effect."""
        at = self._blacklist.get(host)
        if at is None:
            return False
        if self.blacklist_decay_s > 0 and \
                time.monotonic() - at >= self.blacklist_decay_s:
            # Half-open: eligible again, one strike short of the limit —
            # a single new failure re-blacklists without a full cycle.
            del self._blacklist[host]  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock (blacklisted(), reserve_slot(), poll_once())
            self._failures[host] = max(0, self.blacklist_after - 1)  # hvdlint: disable=unguarded-mutation -- _locked suffix contract: every caller holds _lock
            _obs.on_blacklist("probation")
            logger.info("Blacklist decayed for host %s (probation)", host)
            return False
        return True

    def blacklisted(self, host: str) -> bool:
        with self._lock:
            return self._blacklisted_locked(host)

    # --- placement (serving-fleet scaling hooks) ----------------------------

    def reserve_slot(self) -> Optional[str]:
        """Reserve one slot for a new replica on a discovered,
        non-blacklisted host with free capacity; returns the host, or
        None when the fleet is out of room.  The serving
        ``FleetController``'s scale-out placement hook — discovery
        keeps deciding WHERE capacity exists, the controller decides
        WHEN to use it."""
        with self._lock:
            for host in sorted(self._hosts):
                if self._blacklisted_locked(host):
                    continue
                free = self._hosts[host] - self._reserved.get(host, 0)
                if free > 0:
                    self._reserved[host] = self._reserved.get(host, 0) + 1
                    return host
        return None

    def release_slot(self, host: str) -> None:
        """Return a reserved slot (replica retired, or launch failed)."""
        with self._lock:
            n = self._reserved.get(host, 0)
            if n <= 1:
                self._reserved.pop(host, None)
            else:
                self._reserved[host] = n - 1

    def reserved_slots(self) -> int:
        with self._lock:
            return sum(self._reserved.values())

    # --- polling -----------------------------------------------------------

    def poll_once(self) -> bool:
        """One discovery round; fires callbacks on delta.  Returns True
        if membership changed.  A discovery failure no longer escapes:
        below ``failure_threshold`` consecutive errors membership is
        held steady (a flaky script run is not a membership event);
        at the threshold the host set is declared lost."""
        try:
            found = self.discovery.find_available_hosts_and_slots()
            with self._lock:
                self._poll_failures = 0
        except Exception as e:
            with self._lock:
                self._poll_failures += 1
                n = self._poll_failures
            if n < self.failure_threshold:
                logger.warning("Host discovery failed (%d/%d consecutive):"
                               " %s", n, self.failure_threshold, e)
                return False
            logger.error("Host discovery failed %d times consecutively"
                         " (%s); treating membership as lost", n, e)
            _obs.on_membership_loss(len(self.hosts))
            found = {}
        with self._lock:
            found = {h: s for h, s in found.items()
                     if not self._blacklisted_locked(h)}
            old = set(self._hosts)
            new = set(found)
            changed = found != self._hosts
            self._hosts = found
            # Reconcile placement reservations with membership: a host
            # that left took its placed replicas with it, so carrying
            # its reservation forward would read the host as full
            # forever when it rejoins — permanently leaked capacity.
            for gone in [h for h in self._reserved if h not in found]:
                del self._reserved[gone]
        if changed:
            added, removed = new - old, old - new
            logger.info("Membership change: +%s -%s",
                        sorted(added), sorted(removed))
            for cb in self._callbacks:
                cb(added, removed)
        return changed

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._poll_loop,
                                        name="hvd-tpu-elastic-driver",
                                        daemon=True)
        self._thread.start()

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception as e:  # discovery scripts may be flaky
                logger.warning("Host discovery failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def wait_for_available_slots(self, min_slots: int,
                                 timeout_s: Optional[float] = None,
                                 ) -> Dict[str, int]:
        """Block until discovery reports at least ``min_slots`` (reference:
        driver startup barrier with HOROVOD_ELASTIC_TIMEOUT).  Default
        timeout = ``config().elastic_timeout_seconds`` (that env knob),
        600s when uninitialized."""
        if timeout_s is None:
            from .. import basics

            timeout_s = (basics.config().elastic_timeout_seconds
                         if basics.is_initialized() else 600.0)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.poll_once()
            if self.world_size() >= min_slots:
                return self.hosts
            time.sleep(self.poll_interval_s)
        raise TimeoutError(
            f"Timed out waiting for {min_slots} slots; have "
            f"{self.world_size()}")


def hosts_updated_interrupt_callback():
    """Convenience callback: raise ``HostsUpdatedInterrupt`` in the
    training thread at the next commit boundary (reference:
    WorkerNotificationManager's interrupt flow)."""
    flag = {"pending": False}

    def on_update(added, removed):
        flag["pending"] = True

    def check():
        if flag["pending"]:
            flag["pending"] = False
            raise HostsUpdatedInterrupt("host membership changed")

    return on_update, check
