"""The global KV tier: prefix exports, the prefix directory, the
host-memory cold tier and the :class:`KVTier` facade.

Ports ``deepspeed_tpu/serving/kvtier.py``:

* :func:`prefix_hash` — the directory key of a full-block prefix, the
  same process-stable 64-bit hash the JAX package's affinity ring walks;
* :class:`PrefixExport` — a prefix's KV pages in wire form (payload +
  scales exactly as pooled, geometry, an FNV-1a checksum), so adoption-
  wire corruption is detected at the importer (:class:`CorruptExport`)
  and degrades to local prefill instead of landing poisoned pages;
* :class:`PrefixDirectory` — a bounded-staleness map of prefix hash ->
  holders, invalidated synchronously on eviction;
* :class:`ColdTier` — a host-memory LRU of evicted prefixes, accounted
  in KV pages; entries are host copies that hold no device-pool
  reference. An installed chaos injector drops every Nth put
  (``on_cold_put``: injected host-memory pressure);
* :class:`KVTier` — one fleet's directory plus (optionally) its shared
  cold tier, built from a :class:`~deepspeed_tpu_torch.config.
  KVTierConfig`; :meth:`KVTier.publish_residency` is the fleet poll's
  per-replica residency publish with the ``on_directory_publish`` chaos
  hook (``deepspeed_tpu/serving/fleet.py:1389-1399``).

In the port the pages of an export are CPU tensors. A checksum reads each
payload's bytes through an integer view of the same width (numpy has no
bf16), so the port and the JAX package stamp equal checksums on equal
tokens and equal page bytes.

``PrefixDirectory._lock`` and ``ColdTier._lock`` are leaf locks, built
through the lock-order sanitizer's seam (:mod:`~deepspeed_tpu_torch.
resilience.locksan`): nothing blocking runs under them and no other lock
is taken inside them.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..resilience.locksan import named_lock

__all__ = ["PrefixExport", "PrefixDirectory", "ColdTier", "KVTier",
           "CorruptExport", "prefix_hash", "export_checksum"]

# same-width integer views for the dtypes numpy cannot hold
_INT_VIEW = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


class CorruptExport(ValueError):
    """An adopted export failed its checksum at the importer. A
    ValueError, so every "degrade to local prefill" handler covers it."""


def _hash64(data: str) -> int:
    """Stable 64-bit hash (sha256-derived, identical across processes;
    the JAX package's ``router._hash64``)."""
    return int.from_bytes(
        hashlib.sha256(data.encode("utf-8")).digest()[:8], "big")


def prefix_hash(tokens: Sequence[int]) -> int:
    """Directory key of a full-block prefix: the hash the affinity ring
    walks, over the comma-joined tokens."""
    return _hash64(",".join(map(str, tokens)))


def _fold64(acc: int, value: int) -> int:
    """One FNV-1a fold step over a 64-bit accumulator."""
    return ((acc ^ (value & 0xFFFFFFFFFFFFFFFF))
            * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF


def export_checksum(tokens: Sequence[int],
                    payloads: Iterable[bytes] = ()) -> int:
    """FNV-1a over the token stream, then over the first 8 bytes of each
    payload buffer's sha256."""
    acc = 0xCBF29CE484222325
    for t in tokens:
        acc = _fold64(acc, int(t))
    for buf in payloads:
        digest = hashlib.sha256(buf).digest()[:8]
        acc = _fold64(acc, int.from_bytes(digest, "big"))
    return acc


def _raw_bytes(a) -> bytes:
    """A host array's bytes in C order: a tensor through an integer view
    of its width where numpy lacks the dtype, a numpy array as it is."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        view = _INT_VIEW.get(t.dtype)
        return (t.view(view) if view is not None else t).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


class PrefixExport:
    """A prefix's KV pages in wire form, for cross-replica adoption and
    cold-tier storage. ``pages``/``scales`` are ``(k, v)`` host arrays in
    the engine's pool layout ``[n_layers, n_pages, hkv, block, hd]``
    (scales ``[n_layers, n_pages, hkv, block]``), or None without a
    payload; ``geometry()`` is what an importer checks before touching
    its pool."""

    __slots__ = ("tokens", "n_pages", "block_size", "n_layers",
                 "n_kv_heads", "head_dim", "dtype", "kv_quant",
                 "pages", "scales", "checksum", "wire_bytes",
                 "logical_bytes", "source")

    def __init__(self, tokens: Sequence[int], n_pages: int,
                 block_size: int, n_layers: int, n_kv_heads: int,
                 head_dim: int, dtype: str, kv_quant: str,
                 pages: Optional[Any] = None,
                 scales: Optional[Any] = None,
                 wire_bytes: int = 0, logical_bytes: int = 0,
                 source: str = "", checksum: Optional[int] = None):
        self.tokens = tuple(int(t) for t in tokens)
        self.n_pages = int(n_pages)
        self.block_size = int(block_size)
        self.n_layers = int(n_layers)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = str(dtype)
        self.kv_quant = str(kv_quant)
        self.pages = pages
        self.scales = scales
        self.wire_bytes = int(wire_bytes)
        self.logical_bytes = int(logical_bytes)
        self.source = source
        self.checksum = (int(checksum) if checksum is not None
                         else self.compute_checksum())

    def geometry(self) -> Tuple[int, int, int, int, str, str]:
        return (self.block_size, self.n_layers, self.n_kv_heads,
                self.head_dim, self.dtype, self.kv_quant)

    def _payload_buffers(self) -> List[bytes]:
        out: List[bytes] = []
        for arr in (self.pages, self.scales):
            if arr is None:
                continue
            if isinstance(arr, (list, tuple)):
                out.extend(_raw_bytes(a) for a in arr if a is not None)
            else:
                out.append(_raw_bytes(arr))
        return out

    def compute_checksum(self) -> int:
        return export_checksum(self.tokens, self._payload_buffers())

    def verify(self) -> bool:
        """True while the content still matches the stamped checksum."""
        return self.compute_checksum() == self.checksum

    @property
    def key(self) -> Tuple[int, ...]:
        return self.tokens

    @property
    def hash(self) -> int:
        return prefix_hash(self.tokens)


class PrefixDirectory:
    """Bounded-staleness map of prefix hash -> {holder: t_published}.

    ``publish`` replaces one member's residency set, ``invalidate``
    removes one entry (the eviction hook), ``drop_member`` removes a
    dead or migrated replica's entries. ``holders`` returns the fresh
    holders and whether entries exist that all exceeded the bound."""

    def __init__(self, staleness_s: float):
        self.staleness_s = float(staleness_s)
        self._lock = named_lock("PrefixDirectory._lock")
        self._holders: Dict[int, Dict[str, float]] = {}
        self._by_member: Dict[str, set] = {}
        self.publishes = 0
        self.invalidations = 0

    def publish(self, member: str, hashes: Iterable[int],
                now: float) -> None:
        new = set(int(h) for h in hashes)
        with self._lock:
            self.publishes += 1
            old = self._by_member.get(member, set())
            for h in old - new:
                self._forget(h, member)
            for h in new:
                self._holders.setdefault(h, {})[member] = float(now)
            if new:
                self._by_member[member] = new
            else:
                self._by_member.pop(member, None)

    def _forget(self, h: int, member: str) -> None:
        ent = self._holders.get(h)
        if ent is not None:
            ent.pop(member, None)
            if not ent:
                del self._holders[h]

    def invalidate(self, member: str, h: int) -> None:
        """Remove one entry now (fired under the evicting driver's
        serving lock; legal because this lock is a leaf)."""
        h = int(h)
        with self._lock:
            self.invalidations += 1
            self._forget(h, member)
            mh = self._by_member.get(member)
            if mh is not None:
                mh.discard(h)
                if not mh:
                    del self._by_member[member]

    def drop_member(self, member: str) -> int:
        """Remove every entry of a dead or migrated replica. Returns how
        many there were."""
        with self._lock:
            hashes = self._by_member.pop(member, set())
            for h in hashes:
                self._forget(h, member)
            return len(hashes)

    def holders(self, h: int, now: float) -> Tuple[List[str], bool]:
        """(fresh holder names, sorted; stale_only): ``stale_only`` is True
        when entries exist for the hash but none is fresh."""
        with self._lock:
            ent = self._holders.get(int(h))
            if not ent:
                return [], False
            fresh = sorted(m for m, t in ent.items()
                           if now - t <= self.staleness_s)
            return fresh, not fresh

    def has_fresh(self, h: int, now: float) -> bool:
        return bool(self.holders(h, now)[0])

    def entries_for(self, member: str) -> set:
        with self._lock:
            return set(self._by_member.get(member, set()))

    def members(self) -> List[str]:
        with self._lock:
            return sorted(self._by_member)

    def size(self) -> int:
        with self._lock:
            return len(self._holders)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._holders),
                "members": {m: len(hs)
                            for m, hs in sorted(self._by_member.items())},
                "publishes": self.publishes,
                "invalidations": self.invalidations,
            }


class ColdTier:
    """Host-memory LRU of evicted prefixes, accounted in KV pages.
    ``put`` evicts LRU entries until the newcomer fits and refuses
    (counted) an entry bigger than the whole tier; the chaos injector's
    ``on_cold_put`` drops a put (counted in ``chaos_drops``)."""

    def __init__(self, capacity_pages: int):
        if capacity_pages < 1:
            raise ValueError(
                f"cold-tier capacity must be >= 1 page, got "
                f"{capacity_pages}")
        self.capacity_pages = int(capacity_pages)
        self._lock = named_lock("ColdTier._lock")
        self._entries: "OrderedDict[Tuple[int, ...], PrefixExport]" = \
            OrderedDict()
        self._used = 0
        self.puts = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejects = 0
        self.chaos_drops = 0

    def put(self, export: PrefixExport) -> bool:
        """Admit an evicted prefix. Returns False when refused (bigger
        than the tier, or dropped by injected cold pressure)."""
        from ..resilience.chaos import get_fault_injector

        inj = get_fault_injector()
        if inj is not None and inj.on_cold_put():
            with self._lock:
                self.chaos_drops += 1
            return False
        with self._lock:
            self.puts += 1
            if export.n_pages > self.capacity_pages:
                self.rejects += 1
                return False
            old = self._entries.pop(export.key, None)
            if old is not None:
                self._used -= old.n_pages
            while self._used + export.n_pages > self.capacity_pages:
                _, victim = self._entries.popitem(last=False)
                self._used -= victim.n_pages
                self.evictions += 1
            self._entries[export.key] = export
            self._used += export.n_pages
            return True

    def get(self, tokens: Sequence[int]) -> Optional[PrefixExport]:
        key = tuple(int(t) for t in tokens)
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return ent

    def contains(self, tokens: Sequence[int]) -> bool:
        with self._lock:
            return tuple(int(t) for t in tokens) in self._entries

    def invalidate(self, tokens: Sequence[int]) -> bool:
        key = tuple(int(t) for t in tokens)
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is None:
                return False
            self._used -= ent.n_pages
            return True

    @property
    def used_pages(self) -> int:
        with self._lock:
            return self._used

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def entry_pages(self) -> List[int]:
        """Per-entry page counts in LRU order."""
        with self._lock:
            return [e.n_pages for e in self._entries.values()]

    def keys(self) -> List[Tuple[int, ...]]:
        with self._lock:
            return list(self._entries.keys())

    def entries_snapshot(self) -> List[PrefixExport]:
        """Entries in LRU order without touching recency or counters."""
        with self._lock:
            return list(self._entries.values())

    def drop_all(self) -> None:
        with self._lock:
            self._entries.clear()
            self._used = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "used_pages": self._used,
                    "capacity_pages": self.capacity_pages,
                    "puts": self.puts, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "rejects": self.rejects,
                    "chaos_drops": self.chaos_drops}


class KVTier:
    """One fleet's slice of the global KV tier: the shared directory plus
    (optionally) the shared host cold tier, built from a
    :class:`~deepspeed_tpu_torch.config.KVTierConfig`. The fleet owns one
    and hands it to every replica (``ServingEngine.enable_kv_tier``); the
    cold tier is fleet-wide, so a prefix spilled by one replica can be
    re-admitted by any sibling."""

    def __init__(self, config: Any):
        self.config = config
        self.directory = PrefixDirectory(config.directory_staleness_s)
        self.cold: Optional[ColdTier] = (
            ColdTier(config.cold_capacity_pages) if config.cold_tier
            else None)

    def drop_member(self, member: str) -> int:
        """Death / migration hook: the member's directory entries must
        not outlive its pages. The cold tier is not dropped — its entries
        are host copies that survived the donor by construction."""
        return self.directory.drop_member(member)

    def publish_residency(self, member: str,
                          snapshot: Optional[tuple]) -> None:
        """Publish one replica's residency snapshot
        (``ServingEngine.residency_snapshot()``: hashes, t_captured),
        stamped with its capture time, not the publish time, so a wedged
        driver's entries age past the staleness bound. An installed chaos
        injector may add a bogus hash (``on_directory_publish``: a
        directory lie that routing must survive)."""
        if snapshot is None:
            return
        from ..resilience.chaos import get_fault_injector

        hashes, t = snapshot
        inj = get_fault_injector()
        if inj is not None:
            bogus = inj.on_directory_publish(member)
            if bogus is not None:
                hashes = list(hashes) + [bogus]
        self.directory.publish(member, hashes, t)

    def snapshot(self) -> Dict[str, Any]:
        out = {"directory": self.directory.snapshot()}
        if self.cold is not None:
            out["cold"] = self.cold.stats()
        return out
