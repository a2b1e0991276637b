"""Fleet membership, consistent-hash placement, and admission control.

The PR-4 peer exchange made N ranks cooperate — but over a *static* peer
list.  Production fleets churn: ranks restart, move hosts, join late.
This module supplies the three missing substrates:

* **Membership** (`MembershipRegistry` + `FleetMember`): ranks register
  with a registry (hosted by any `PeerShardServer` via its ``/fleet/*``
  endpoints) and heartbeat it.  A missed heartbeat marks the peer
  *suspect* — consumers feed that straight into the request-path circuit
  breaker instead of waiting to burn a request-time timeout.  A dead
  peer is swept from the view; a re-registered one is re-admitted live.
* **Placement** (`HashRing`): consistent hashing with virtual nodes maps
  each shard name to an owner (plus replicas).  A join/leave remaps only
  the arcs that changed hands — ~1/N of the keyspace — instead of
  reshuffling everything the way modulo placement would.
* **Admission** (`TokenBucket` / `AdmissionController`): per-tenant
  byte-rate quotas and a max-inflight cap.  Over-quota requests get a
  structured 429 + ``Retry-After`` (honored by ``RetryingSource``), so
  one greedy consumer degrades gracefully instead of collapsing the
  fleet for everyone.

Everything here is dependency-free (stdlib only) and clock-injectable
for deterministic tests.
"""

from __future__ import annotations

import bisect
import hashlib
import http.client
import json
import threading
import time
import urllib.parse
from typing import Callable, Iterable, Sequence

__all__ = [
    "AdmissionController",
    "FleetMember",
    "HashRing",
    "MembershipRegistry",
    "TENANT_HEADER",
    "TokenBucket",
]

#: Header carrying the tenant identity for admission control.
TENANT_HEADER = "X-Tenant"


def _hash64(key: str) -> int:
    """Deterministic 64-bit hash of ``key``.

    Python's builtin ``hash()`` is salted per process (PYTHONHASHSEED),
    which would remap 100% of the keyspace on every restart — the exact
    failure consistent hashing exists to avoid.  blake2b is stable,
    fast, and already in hashlib.
    """
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Each member contributes ``vnodes`` points on a 64-bit ring; a key is
    owned by the first member point clockwise from the key's hash.
    ``owners(key, n)`` keeps walking to collect ``n`` *distinct* members
    (owner + replicas).  ``rebuild`` swaps in a new member set and
    returns how many vnode arcs changed primary owner — the bounded
    remap the tests and bench gate assert on.
    """

    def __init__(self, members: Iterable[str] = (), *, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._points: list[int] = []
        self._owners: list[str] = []
        self.members: tuple[str, ...] = ()
        self.rebuild(members)

    def _build(self, members: Sequence[str]) -> tuple[list[int], list[str]]:
        pts: list[tuple[int, str]] = []
        for m in members:
            for j in range(self.vnodes):
                pts.append((_hash64(f"{m}#{j}"), m))
        pts.sort()
        return [p for p, _ in pts], [m for _, m in pts]

    def rebuild(self, members: Iterable[str]) -> int:
        """Swap in ``members``; return the number of arc cut points whose
        primary owner changed (0 on the first build or a no-op)."""
        new_members = tuple(dict.fromkeys(members))  # dedupe, keep order
        if new_members == self.members:
            return 0
        old_points, old_owners = self._points, self._owners
        new_points, new_owners = self._build(new_members)
        moved = 0
        if old_points and new_points:
            # Sweep the union of cut points: each is the low edge of an
            # arc that is uniform in both rings, so comparing owners at
            # the cut counts exactly the arcs that changed hands.
            cuts = sorted(set(old_points) | set(new_points))
            for c in cuts:
                if self._owner_from(old_points, old_owners, c) != self._owner_from(
                    new_points, new_owners, c
                ):
                    moved += 1
        self._points, self._owners = new_points, new_owners
        self.members = new_members
        return moved

    @staticmethod
    def _owner_from(points: list[int], owners: list[str], key: int) -> str | None:
        if not points:
            return None
        i = bisect.bisect_left(points, key)
        if i == len(points):
            i = 0
        return owners[i]

    def owners(self, key: str, n: int = 1) -> list[str]:
        """Owner + up to ``n - 1`` distinct replicas for ``key``, in ring
        order.  Fewer than ``n`` if the ring has fewer members."""
        if not self._points or n < 1:
            return []
        h = _hash64(key)
        i = bisect.bisect_left(self._points, h)
        out: list[str] = []
        for k in range(len(self._points)):
            m = self._owners[(i + k) % len(self._points)]
            if m not in out:
                out.append(m)
                if len(out) == n:
                    break
        return out


class MembershipRegistry:
    """Server-side fleet view: who is live, who went quiet.

    Ranks ``register`` once and ``heartbeat`` periodically.  The registry
    is passive — liveness is evaluated lazily on access (no sweeper
    thread): a member whose last heartbeat is older than
    ``suspect_after_s`` is *suspect* (still in the view, flagged so
    consumers can bench it preemptively); older than ``dead_after_s`` it
    is removed.  ``version`` bumps on every view change so members can
    cheap-poll.
    """

    def __init__(
        self,
        *,
        suspect_after_s: float = 3.0,
        dead_after_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if dead_after_s <= suspect_after_s:
            raise ValueError("dead_after_s must exceed suspect_after_s")
        self.suspect_after_s = suspect_after_s
        self.dead_after_s = dead_after_s
        self._clock = clock
        self._lock = threading.Lock()
        self._members: dict[str, dict] = {}  # id -> {url, last, suspect}
        self.version = 0
        self.joins = 0
        self.leaves = 0
        self.suspects = 0
        self.deaths = 0

    def _sweep_locked(self) -> None:
        now = self._clock()
        for pid in list(self._members):
            m = self._members[pid]
            age = now - m["last"]
            if age >= self.dead_after_s:
                del self._members[pid]
                self.deaths += 1
                self.version += 1
            elif age >= self.suspect_after_s and not m["suspect"]:
                m["suspect"] = True
                self.suspects += 1
                self.version += 1

    def register(self, peer_id: str, url: str) -> dict:
        """Admit (or re-admit) a member; returns the membership view."""
        url = url.rstrip("/")
        with self._lock:
            self._sweep_locked()
            m = self._members.get(peer_id)
            if m is None or m["url"] != url or m["suspect"]:
                self.joins += 1
                self.version += 1
            self._members[peer_id] = {
                "url": url,
                "last": self._clock(),
                "suspect": False,
            }
            return self._view_locked()

    def heartbeat(self, peer_id: str) -> bool:
        """Refresh liveness.  False means the registry no longer knows
        this member (it was swept dead) — the client must re-register."""
        with self._lock:
            self._sweep_locked()
            m = self._members.get(peer_id)
            if m is None:
                return False
            m["last"] = self._clock()
            if m["suspect"]:
                m["suspect"] = False
                self.version += 1
            return True

    def leave(self, peer_id: str) -> None:
        with self._lock:
            self._sweep_locked()
            if self._members.pop(peer_id, None) is not None:
                self.leaves += 1
                self.version += 1

    def _view_locked(self) -> dict:
        live = []
        suspect = []
        for pid, m in sorted(self._members.items()):
            entry = {"id": pid, "url": m["url"]}
            (suspect if m["suspect"] else live).append(entry)
        return {"version": self.version, "live": live, "suspect": suspect}

    def members(self) -> dict:
        """Current view: ``{"version", "live": [...], "suspect": [...]}``."""
        with self._lock:
            self._sweep_locked()
            return self._view_locked()

    def stats(self) -> dict:
        with self._lock:
            self._sweep_locked()
            n_suspect = sum(1 for m in self._members.values() if m["suspect"])
            return {
                "peers_live": len(self._members) - n_suspect,
                "peers_suspect": n_suspect,
                "version": self.version,
                "joins": self.joins,
                "leaves": self.leaves,
                "suspect_transitions": self.suspects,
                "deaths": self.deaths,
            }


def _fleet_call(registry_url: str, path: str, timeout: float) -> dict:
    """One JSON GET against a fleet registry endpoint.

    Uses ``http.client`` directly (not urllib) so env proxy settings
    can't hijack intra-fleet localhost traffic.
    """
    parts = urllib.parse.urlsplit(registry_url)
    conn = http.client.HTTPConnection(
        parts.hostname, parts.port or 80, timeout=timeout
    )
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise OSError(f"{registry_url}{path}: HTTP {resp.status}")
        return json.loads(body)
    finally:
        conn.close()


class FleetMember:
    """Client-side membership agent: registers, heartbeats, and keeps a
    ``PeerShardSource`` synced to the live ring.

    A rank that *serves* passes ``serve_url`` (it appears in other
    ranks' views); a pure consumer omits it and only mirrors the view.
    Suspect peers from the view are benched into the circuit breaker
    immediately (``mark_suspect``); a peer transitioning suspect→live is
    offered back for exactly one half-open probe (``mark_live``) rather
    than force-closed — the request path retains final say.
    """

    def __init__(
        self,
        registry_url: str,
        *,
        peer_id: str | None = None,
        serve_url: str | None = None,
        peers=None,
        heartbeat_s: float = 1.0,
        timeout: float = 2.0,
    ):
        self.registry_url = registry_url.rstrip("/")
        self.peer_id = peer_id or f"member-{_hash64(registry_url + repr(id(self))):x}"
        self.serve_url = serve_url.rstrip("/") if serve_url else None
        self.peers = peers
        self.heartbeat_s = heartbeat_s
        self.timeout = timeout
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_suspect: set[str] = set()
        self._seen_version = -1
        self.heartbeats = 0
        self.refreshes = 0
        self.registry_errors = 0

    # -- registry RPCs ------------------------------------------------
    def _register(self) -> dict | None:
        if self.serve_url is None:
            return _fleet_call(self.registry_url, "/fleet/members", self.timeout)
        q = urllib.parse.urlencode({"id": self.peer_id, "url": self.serve_url})
        return _fleet_call(self.registry_url, f"/fleet/register?{q}", self.timeout)

    def _heartbeat(self) -> bool:
        if self.serve_url is None:
            return True
        q = urllib.parse.urlencode({"id": self.peer_id})
        out = _fleet_call(self.registry_url, f"/fleet/heartbeat?{q}", self.timeout)
        return bool(out.get("ok"))

    def _members(self) -> dict:
        return _fleet_call(self.registry_url, "/fleet/members", self.timeout)

    # -- view application --------------------------------------------
    def _apply(self, view: dict) -> None:
        if self.peers is None:
            return
        version = view.get("version", 0)
        live = [m["url"] for m in view.get("live", ())]
        suspect = [m["url"] for m in view.get("suspect", ())]
        if self.serve_url is not None:
            live = [u for u in live if u != self.serve_url]
            suspect = [u for u in suspect if u != self.serve_url]
        if version == self._seen_version:
            return
        self._seen_version = version
        self.peers.sync_membership(live + suspect, suspect)
        now_suspect = set(suspect)
        # Only a suspect -> live *transition* earns a probe offer; an
        # always-live peer must not have its request-path cooldown reset.
        for url in self._last_suspect - now_suspect:
            if url in live:
                self.peers.mark_live(url)
        self._last_suspect = now_suspect

    def poll(self) -> None:
        """One register/heartbeat + view-refresh cycle (also the loop body)."""
        try:
            if not self._heartbeat():
                view = self._register()  # swept dead: re-join
            else:
                view = self._members()
            self.heartbeats += 1
            if view is not None:
                self.refreshes += 1
                self._apply(view)
        except (OSError, ValueError, http.client.HTTPException):
            self.registry_errors += 1

    def _run(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            self.poll()

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "FleetMember":
        try:
            view = self._register()
            if view is not None:
                self.refreshes += 1
                self._apply(view)
        except (OSError, ValueError, http.client.HTTPException):
            self.registry_errors += 1
        self._thread = threading.Thread(
            target=self._run, name="fleet-member", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.serve_url is not None:
            try:  # best-effort goodbye; the sweep covers us if it fails
                q = urllib.parse.urlencode({"id": self.peer_id})
                _fleet_call(self.registry_url, f"/fleet/leave?{q}", self.timeout)
            except (OSError, ValueError, http.client.HTTPException):
                self.registry_errors += 1

    def __enter__(self) -> "FleetMember":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        return {
            "heartbeats": self.heartbeats,
            "refreshes": self.refreshes,
            "registry_errors": self.registry_errors,
            "seen_version": self._seen_version,
        }


class TokenBucket:
    """Byte-rate token bucket: sustained ``rate_bps`` with ``burst_bytes``
    of headroom.

    ``try_take(n)`` either admits (returns 0.0, debits — the balance may
    go negative for bodies larger than the burst, which is what enforces
    the *long-run* rate) or rejects with the seconds until ``n`` would be
    affordable, leaving tokens untouched.  The afford threshold is
    ``min(n, burst)`` so a single body larger than the whole burst can
    still eventually be admitted instead of 429ing forever.
    """

    def __init__(
        self,
        rate_bps: float,
        burst_bytes: float | None = None,
        *,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate_bps <= 0:
            raise ValueError("rate_bps must be > 0")
        self.rate_bps = float(rate_bps)
        self.burst_bytes = float(burst_bytes if burst_bytes is not None else rate_bps)
        self._clock = clock
        self._tokens = self.burst_bytes
        self._last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.burst_bytes, self._tokens + (now - self._last) * self.rate_bps
        )
        self._last = now

    def try_take(self, n: int) -> float:
        """0.0 = admitted (tokens debited); > 0 = rejected, retry after
        that many seconds."""
        with self._lock:
            self._refill_locked()
            need = min(float(n), self.burst_bytes)
            if self._tokens >= need:
                self._tokens -= float(n)
                return 0.0
            return (need - self._tokens) / self.rate_bps


class AdmissionController:
    """Per-tenant token-bucket quotas plus a global max-inflight cap.

    Attach one to ``PeerShardServer`` / ``ShardHTTPServer``: the handler
    calls ``start_request()``/``end_request()`` around each request and
    ``admit(tenant, nbytes)`` before sending a body.  A non-None return
    is the ``Retry-After`` seconds for a structured 429.
    """

    def __init__(
        self,
        *,
        max_inflight: int | None = None,
        default_bps: float | None = None,
        burst_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_inflight = max_inflight
        self.default_bps = default_bps
        self.burst_s = burst_s
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}
        self._inflight = 0
        self.retry_wait_s = 0.05  # Retry-After for inflight-cap 429s
        self.quota_rejections = 0
        self.inflight_rejections = 0
        self.admitted = 0

    def set_quota(
        self, tenant: str, rate_bps: float, burst_bytes: float | None = None
    ) -> None:
        burst = burst_bytes if burst_bytes is not None else rate_bps * self.burst_s
        with self._lock:
            self._buckets[tenant] = TokenBucket(
                rate_bps, burst, clock=self._clock
            )

    def _bucket(self, tenant: str) -> TokenBucket | None:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None and self.default_bps is not None:
                b = TokenBucket(
                    self.default_bps,
                    self.default_bps * self.burst_s,
                    clock=self._clock,
                )
                self._buckets[tenant] = b
            return b

    def admit(self, tenant: str, nbytes: int) -> float | None:
        """None = admitted; float = rejected, Retry-After seconds."""
        b = self._bucket(tenant)
        if b is None:
            with self._lock:
                self.admitted += 1
            return None
        wait = b.try_take(nbytes)
        with self._lock:
            if wait > 0.0:
                self.quota_rejections += 1
            else:
                self.admitted += 1
        return None if wait == 0.0 else wait

    def start_request(self) -> bool:
        """Reserve an inflight slot; False = at capacity (429)."""
        with self._lock:
            if self.max_inflight is not None and self._inflight >= self.max_inflight:
                self.inflight_rejections += 1
                return False
            self._inflight += 1
            return True

    def end_request(self) -> None:
        with self._lock:
            self._inflight -= 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "admission_rejections": self.quota_rejections
                + self.inflight_rejections,
                "quota_rejections": self.quota_rejections,
                "inflight_rejections": self.inflight_rejections,
                "admitted": self.admitted,
                "inflight": self._inflight,
                "tenants": len(self._buckets),
            }
