"""Chunk-granular prefix KV cache: a radix tree over chunk-aligned prefixes.

Port of :mod:`accelerate_tpu.serving.prefix_cache` for both engines.
Under a serving queue with shared system or few-shot prefixes, most prefill
work recomputes KV the pool already holds for an earlier request.  The cache
keeps that KV at **chunk granularity**, the bucket boundaries
:func:`~accelerate_tpu_torch.serving.pool.plan_chunks` prefills at: a node is
one full chunk of token ids whose KV sits either in physical pages of the
shared page pool (:meth:`PrefixCache.insert_pages`, the paged engine: a
later request whose prompt starts with the node's whole prefix aliases
those pages into its block table instead of prefilling them) or in the
node's own device slab ``k``/``v [L, 1, chunk, Hkv, D]``
(:meth:`PrefixCache.insert`, the slab engine: a hit copies the slab into
the prefill scratch).

A node's identity is the whole token prefix from the root; its key inside
the parent is a rolling hash of that prefix (:func:`rolling_hash`), verified
token for token on every lookup, so a hash collision never serves wrong KV.
KV at a position depends on every earlier token, which is why only exact
whole-prefix matches are reused and padded final chunks are never cached.

Lifecycle: nodes are pinned (``refs``) while a request between admission and
install depends on them; eviction is leaf-only LRU among unpinned nodes,
under a byte ``capacity`` (``ServingEngine(prefix_cache_mb=...)``), so every
resident node's prefix chain stays resident.

Tiers (paged engine only): with ``host_capacity_bytes > 0`` and a ``spill`` hook, a device-tier
eviction *demotes* the node: the hook gathers the node's pages and their
dequantization scales off the device into a host ring under its own byte
budget and drops the node's page references, and the node stays in the tree
with ``tier == "host"`` holding the payload.  A later hit *promotes* it: the
engine allocates fresh pages, installs the payload behind the window in
flight and calls :meth:`PrefixCache.promote_node`.  An optional disk ring
(``disk_capacity_bytes`` + ``disk_dir``) sits behind the host ring: host-tier
LRU victims whose payload has landed on the host are written out instead of
dropped.  Each tier runs its own leaf-only LRU, pinned nodes never demote,
and a matched chain is always ``device* host* disk*`` in order.

A landed payload is a tuple of CPU tensors (page codes or values and their
f32 scales).  Anything else the spill hook returns is a payload in flight,
which is never written to disk.  A disk file holds each tensor's raw bytes
beside its dtype and shape (numpy has no bf16 and no e4m3), so a payload
comes back bit for bit.

The reference also publishes telemetry gauges and counters; the port keeps
the counts in :meth:`PrefixCache.stats` only.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry import MetricsRegistry, get_registry

#: Seed for the root prefix hash (djb2's seed; any odd constant works).
_HASH_SEED = 5381
#: Large Mersenne prime modulus keeps the rolling hash in cheap python ints.
_HASH_MOD = (1 << 61) - 1
_HASH_MULT = 1_000_003


def rolling_hash(prev: int, tokens) -> int:
    """Extend prefix hash ``prev`` over ``tokens`` (order-sensitive).

    ``rolling_hash(rolling_hash(seed, a), b) == rolling_hash(seed, a + b)``:
    a node's key is the hash of its entire prefix, computed incrementally
    from its parent's key."""
    h = int(prev)
    for t in np.asarray(tokens).ravel().tolist():
        h = (h * _HASH_MULT + int(t) + 1) % _HASH_MOD
    return h


def is_landed(payload) -> bool:
    """Is ``payload`` a spilled chunk held on the host (a tuple of CPU
    tensors), as opposed to one still in flight?"""
    return (isinstance(payload, tuple) and bool(payload)
            and all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in payload))


def save_payload(path: str, payload: Sequence[torch.Tensor]) -> None:
    """Write a landed payload to ``path``: each tensor's raw bytes, dtype
    and shape."""
    arrays = {}
    for i, t in enumerate(payload):
        t = t.contiguous()
        arrays[f"bytes{i}"] = t.view(torch.uint8).reshape(-1).numpy()
        arrays[f"dtype{i}"] = np.asarray(str(t.dtype).replace("torch.", ""))
        arrays[f"shape{i}"] = np.asarray(t.shape, np.int64)
    with open(path, "wb") as f:
        np.savez(f, count=np.asarray(len(payload)), **arrays)


def load_payload(path: str) -> Tuple[torch.Tensor, ...]:
    """Read back what :func:`save_payload` wrote, bit for bit."""
    with np.load(path) as z:
        out = []
        for i in range(int(z["count"])):
            dtype = getattr(torch, str(z[f"dtype{i}"]))
            raw = torch.from_numpy(z[f"bytes{i}"])
            out.append(raw.view(dtype).reshape(tuple(int(n) for n in z[f"shape{i}"])))
        return tuple(out)


def rank_disk_dir(disk_dir: Optional[str], rank: int) -> Optional[str]:
    """The disk ring's directory of tensor-parallel rank ``rank`` (made if
    missing): ranks on one host spill different heads of the same chunks,
    under the same file names."""
    if not disk_dir:
        return disk_dir
    path = os.path.join(disk_dir, f"tp_rank{int(rank)}")
    os.makedirs(path, exist_ok=True)
    return path


class PrefixNode:
    """One cached chunk: token ids + its KV, either the physical page ids of
    the shared page pool (``pages``, the paged engine) or a device slab of
    its own (``k``/``v``, the slab engine).  A page node holds one
    allocator reference per page for as long as it is device-tier resident;
    a spilled node (``tier != "device"``)
    holds no pages and keeps its KV in ``host`` instead: the spill hook's
    payload (in flight, then landed) or, for the disk tier, the path of the
    ring file."""

    __slots__ = ("key", "tokens", "parent", "children", "k", "v", "pages", "nbytes", "refs",
                 "last_used", "tier", "host")

    def __init__(self, key: int, tokens: Optional[np.ndarray], parent,
                 pages: Optional[Tuple[int, ...]] = None, nbytes: int = 0, k=None, v=None):
        self.key = key
        self.tokens = tokens                 # [chunk] int32; None for the root
        self.parent = parent
        self.children: Dict[int, "PrefixNode"] = {}
        self.k = k                           # [L, 1, chunk, Hkv, D] device slab (slab engine)
        self.v = v
        self.pages = pages                   # physical page ids (paged engine)
        self.nbytes = int(nbytes)
        self.refs = 0
        self.last_used = 0
        self.tier = "device"                 # "device" | "host" | "disk"
        self.host = None                     # spilled payload (tier != device)

    def __repr__(self) -> str:  # debugging aid only
        n = 0 if self.tokens is None else len(self.tokens)
        return (f"PrefixNode(len={n}, tier={self.tier}, refs={self.refs}, "
                f"children={len(self.children)}, bytes={self.nbytes})")


class PrefixCache:
    """Host-managed radix cache of page-pool or slab KV with LRU byte budgeting.

    Parameters
    ----------
    capacity_bytes: retained-page budget (device tier).  Pinned (``refs >
        0``) nodes never evict, so in-flight requests can transiently hold
        the cache over budget.
    on_evict: called with each node as it leaves the cache entirely: the
        paged engine drops the allocator references its pages hold (pages
        survive while lanes still alias them); the slab engine passes none.  A demotion to the host ring is not
        an eviction: the ``spill`` hook releases the page references itself.
    host_capacity_bytes: host-RAM spill ring budget; 0 disables tiering and
        evictions drop.
    spill: ``spill(node) -> payload | None`` — the engine hook that gathers
        a device-tier node's pages off the device (returning the payload the
        node will carry) and releases its page references.  ``None`` means
        the node cannot be spilled and is dropped instead.
    disk_capacity_bytes / disk_dir: optional disk ring behind the host ring;
        host-tier LRU victims with landed payloads demote into files under
        ``disk_dir`` instead of dropping.
    registry: metrics registry for the ``serve/prefix_*`` gauges and the
        eviction/spill/promotion counters (default: the process registry).
    shards: under tensor-parallel serving each rank's cache holds its own
        kv heads of every chunk (its host and disk tiers too, the disk files
        under a directory of the rank's own, :func:`rank_disk_dir`), one of
        ``shards`` equal head shards; a slab node is charged for the whole
        chunk, as the page nodes are (``chunk_bytes``), so that every rank
        and the reference make the same budget decisions.
    """

    def __init__(self, capacity_bytes: int, on_evict=None, host_capacity_bytes: int = 0,
                 spill=None, disk_capacity_bytes: int = 0, disk_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None, shards: int = 1):
        self.on_evict = on_evict
        self.spill = spill
        self.capacity = int(capacity_bytes)
        if self.capacity <= 0:
            raise ValueError(f"capacity_bytes must be positive, got {capacity_bytes}")
        self.host_capacity = int(host_capacity_bytes or 0)
        self.disk_capacity = int(disk_capacity_bytes or 0)
        self.disk_dir = disk_dir
        if self.disk_capacity > 0 and not disk_dir:
            raise ValueError("disk_capacity_bytes > 0 requires disk_dir")
        self.shards = int(shards)
        self.root = PrefixNode(_HASH_SEED, None, None)
        self.bytes = 0
        self.host_bytes = 0
        self.disk_bytes = 0
        self.evictions = 0
        self.host_evictions = 0
        self.spills = 0
        self.promotions = 0
        self.disk_writes = 0
        self.disk_s = 0.0
        self._nodes: List[PrefixNode] = []
        self._host_nodes: List[PrefixNode] = []
        self._disk_nodes: List[PrefixNode] = []
        self._disk_seq = 0
        self._clock = 0
        registry = registry if registry is not None else get_registry()
        self._bytes_gauge = registry.gauge(
            "serve/prefix_cache_bytes", help="retained prefix KV slab bytes")
        self._nodes_gauge = registry.gauge(
            "serve/prefix_cache_nodes", help="resident prefix cache nodes")
        self._host_bytes_gauge = registry.gauge(
            "serve/prefix_host_bytes",
            help="prefix KV bytes resident in the host-RAM spill ring")
        self._evict_counter = registry.counter(
            "serve/prefix_cache_evictions_total",
            help="prefix cache nodes dropped by LRU eviction")
        self._spill_counter = registry.counter(
            "serve/prefix_spills_total",
            help="prefix nodes demoted device -> host spill ring")
        self._promote_counter = registry.counter(
            "serve/prefix_promotions_total",
            help="spilled prefix nodes re-admitted to the device tier")

    # ---------------------------------------------------------------- lookup
    def _touch(self, node: PrefixNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    def match(self, prompt: np.ndarray, chunks: Sequence[Tuple[int, int]]) -> List[PrefixNode]:
        """Longest chain of cached nodes covering ``prompt``'s leading chunks.

        Walks ``chunks`` (the request's :func:`plan_chunks` plan) from the
        root; stops at the first partial chunk or the first miss.  Matched
        nodes are LRU-touched but not pinned (callers pin with
        :meth:`acquire`).  Spilled nodes hit like device nodes; the engine
        promotes them at admission."""
        prompt = np.asarray(prompt)
        nodes: List[PrefixNode] = []
        node, start = self.root, 0
        for bucket, valid in chunks:
            if valid != bucket:
                break
            tokens = prompt[start:start + bucket]
            child = node.children.get(rolling_hash(node.key, tokens))
            if child is None or not np.array_equal(child.tokens, tokens):
                break
            self._touch(child)
            nodes.append(child)
            node, start = child, start + bucket
        return nodes

    # --------------------------------------------------------------- pinning
    def acquire(self, nodes: Iterable[PrefixNode]) -> None:
        """Pin ``nodes`` against eviction (a request depends on their KV)."""
        for n in nodes:
            n.refs += 1

    def release(self, nodes: Iterable[PrefixNode]) -> None:
        """Drop pins taken by :meth:`acquire`; touched so fresh users rank hot."""
        for n in nodes:
            n.refs -= 1
            if n.refs < 0:
                raise RuntimeError(f"prefix cache refcount underflow on {n!r}")
            self._touch(n)

    # -------------------------------------------------------------- mutation
    def insert(self, parent: Optional[PrefixNode], tokens, k: torch.Tensor,
               v: torch.Tensor) -> Optional[PrefixNode]:
        """Retain one freshly prefilled chunk as a device slab of its own
        (the slab engine; ``accelerate_tpu/serving/prefix_cache.py:243-271``):
        ``k``/``v [L, 1, chunk, Hkv, D]``, copies the caller made, charged
        at their bytes.  Returns the resident node (the existing one, its
        slab kept, if this exact chunk is cached already), or ``None`` when
        the chunk cannot be retained: the byte budget cannot be met even
        after eviction, or a hash collision with another token sequence
        occupies the key.  The caller then stops extending this chain."""
        parent = parent if parent is not None else self.root
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        key = rolling_hash(parent.key, tokens)
        existing = parent.children.get(key)
        if existing is not None:
            if np.array_equal(existing.tokens, tokens):
                self._touch(existing)
                return existing
            return None  # 61-bit hash collision: keep the resident entry
        nbytes = (k.numel() * k.element_size() + v.numel() * v.element_size()) * self.shards
        if not self._make_room(nbytes):
            return None
        node = PrefixNode(key, tokens, parent, nbytes=nbytes, k=k, v=v)
        self._touch(node)
        parent.children[key] = node
        self._nodes.append(node)
        self.bytes += nbytes
        self._publish()
        return node

    def insert_pages(self, parent: Optional[PrefixNode], tokens, page_ids: Sequence[int],
                     nbytes: int) -> Optional[PrefixNode]:
        """Retain one freshly prefilled chunk as page references (zero
        copies: the lane's own pages are aliased).  The caller takes one
        allocator reference per page iff a new node was created or a spilled
        node was re-admitted in place, which it detects by ``node.pages ==
        tuple(page_ids)``.

        Returns the resident node (the existing one on an exact re-insert),
        or ``None`` when the chunk cannot be retained: the byte budget cannot
        be met even after eviction, or a hash collision with another token
        sequence occupies the key.  The caller then stops extending this
        chain."""
        parent = parent if parent is not None else self.root
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        key = rolling_hash(parent.key, tokens)
        existing = parent.children.get(key)
        if existing is not None:
            if np.array_equal(existing.tokens, tokens):
                self._touch(existing)
                if existing.tier != "device":
                    # a degraded promotion re-prefilled this chunk: fold the
                    # fresh pages back in so the node heals to the device tier
                    self._readmit(existing, page_ids, int(nbytes))
                return existing
            return None  # 61-bit hash collision: keep the resident entry
        if not self._make_room(int(nbytes)):
            return None
        node = PrefixNode(key, tokens, parent, pages=tuple(int(p) for p in page_ids),
                          nbytes=nbytes)
        self._touch(node)
        parent.children[key] = node
        self._nodes.append(node)
        self.bytes += node.nbytes
        self._publish()
        return node

    def evict_one(self) -> bool:
        """Force one LRU device-tier eviction (page-pressure reclaim): a
        demotion to the host ring when tiering is on, a drop otherwise;
        either way the node's page references are released.  False when
        nothing is evictable."""
        skip: set = set()
        while True:
            victim = self._lru_device_victim(skip)
            if victim is None:
                return False
            if self._evict(victim):
                return True
            skip.add(id(victim))

    def flush(self) -> int:
        """Drop every unpinned node from every tier, leaf-first, never
        demoting.  Pinned nodes survive; callers drop queued requests' pins
        first (:meth:`Scheduler.drop_cache_pins`).  Returns nodes removed."""
        before = len(self._nodes) + len(self._host_nodes) + len(self._disk_nodes)
        skip: set = set()
        while True:
            victim = self._lru_device_victim(skip)
            if victim is None:
                break
            if not self._drop_subtree(victim):
                skip.add(id(victim))
        for nodes, drop in ((self._host_nodes, self._drop_host),
                            (self._disk_nodes, self._drop_disk)):
            while True:
                victim = self._lru_leaf(nodes)
                if victim is None:
                    break
                drop(victim)
        return before - (len(self._nodes) + len(self._host_nodes) + len(self._disk_nodes))

    # ------------------------------------------------------------- promotion
    def node_payload(self, node: PrefixNode):
        """The spilled KV payload for promotion: the spill hook's value for
        host-tier nodes (in flight, or landed), or the tensors reloaded from
        the disk ring.  ``None`` when the node is not spilled or the ring
        file is gone or torn."""
        if node.tier == "host":
            return node.host
        if node.tier == "disk":
            t0 = time.perf_counter()
            try:
                return load_payload(node.host)
            except (OSError, ValueError, KeyError, RuntimeError, TypeError):
                return None
            finally:
                self.disk_s += time.perf_counter() - t0
        return None

    def settle_payload(self, node: PrefixNode, payload) -> None:
        """Replace a host-tier node's in-flight payload with the landed one
        (the engine calls this at the drain)."""
        if node.tier == "host":
            node.host = payload

    def discard_spilled(self, node: PrefixNode) -> None:
        """Drop a spilled node (and its spilled subtree) whose payload can no
        longer be trusted.  No-op for device-tier or detached nodes."""
        if node.tier == "device" or node.key not in node.parent.children:
            return
        self._drop_subtree(node)

    def promote_node(self, node: PrefixNode, page_ids: Sequence[int]) -> bool:
        """Record a promotion of a spilled node (the engine has installed its
        payload into ``page_ids``: that counts either way) and try to
        re-admit it to the device tier with those pages.  The caller takes
        one allocator reference per page iff this returns True.  Re-admission
        fails, the node staying spilled with its payload, when the parent is
        not device-resident or the device budget cannot be met."""
        if node.tier == "device":
            return False
        self.promotions += 1
        self._promote_counter.inc()
        if not self._readmit(node, page_ids, node.nbytes):
            return False
        self._touch(node)
        return True

    def _readmit(self, node: PrefixNode, page_ids: Sequence[int], nbytes: int) -> bool:
        """host/disk -> device transition in place (promotion, and the
        degraded-promotion heal in :meth:`insert_pages`)."""
        if node.parent.tier != "device":
            return False  # keep the device* host* disk* chain ordering
        if not self._make_room(int(nbytes)):
            return False
        if node.tier == "host":
            self._host_nodes.remove(node)
            self.host_bytes -= node.nbytes
        else:
            self._disk_nodes.remove(node)
            self.disk_bytes -= node.nbytes
            self._unlink_disk(node)
        node.host = None
        node.tier = "device"
        node.pages = tuple(int(p) for p in page_ids)
        node.nbytes = int(nbytes)
        self._nodes.append(node)
        self.bytes += node.nbytes
        self._publish()
        return True

    # -------------------------------------------------------------- eviction
    def _make_room(self, nbytes: int) -> bool:
        """Evict LRU unpinned device leaves until ``nbytes`` more fits; False
        if the survivors (pinned or interior) cannot shrink far enough."""
        if nbytes > self.capacity:
            return False
        skip: set = set()
        while self.bytes + nbytes > self.capacity:
            victim = self._lru_device_victim(skip)
            if victim is None:
                return False
            if not self._evict(victim):
                skip.add(id(victim))
        return True

    def _lru_device_victim(self, skip=()) -> Optional[PrefixNode]:
        """LRU unpinned device node with no device-tier children (spilled
        children do not shield a parent: it spills too, or the whole spilled
        subtree drops)."""
        victim = None
        for n in self._nodes:
            if n.refs > 0 or id(n) in skip:
                continue
            if any(c.tier == "device" for c in n.children.values()):
                continue
            if victim is None or n.last_used < victim.last_used:
                victim = n
        return victim

    @staticmethod
    def _lru_leaf(nodes: List[PrefixNode]) -> Optional[PrefixNode]:
        victim = None
        for n in nodes:
            if n.refs > 0 or n.children:
                continue
            if victim is None or n.last_used < victim.last_used:
                victim = n
        return victim

    def _evict(self, node: PrefixNode) -> bool:
        """Demote ``node`` to the host ring when tiering allows; drop it (and
        any spilled descendants) otherwise.  False when neither is possible
        (a pinned spilled descendant)."""
        if self.host_capacity > 0 and self.spill is not None and node.pages \
                and self._demote(node):
            return True
        return self._drop_subtree(node)

    def _demote(self, node: PrefixNode) -> bool:
        """device -> host: make host-ring room first, then run the engine's
        spill hook, which releases the page references."""
        if node.nbytes > self.host_capacity:
            return False
        while self.host_bytes + node.nbytes > self.host_capacity:
            victim = self._lru_leaf(self._host_nodes)
            if victim is None:
                return False
            self._remove_host(victim)
        payload = self.spill(node)
        if payload is None:
            return False
        node.host = payload
        node.tier = "host"
        node.pages = None
        self._nodes.remove(node)
        self.bytes -= node.nbytes
        self._host_nodes.append(node)
        self.host_bytes += node.nbytes
        self.spills += 1
        self._spill_counter.inc()
        self._publish()
        return True

    def _drop_subtree(self, node: PrefixNode) -> bool:
        """Drop ``node`` and its spilled descendants leaf-first; refuses,
        removing nothing, when any descendant is pinned."""
        stack, order = [node], []
        while stack:
            n = stack.pop()
            if n.refs > 0:
                return False
            order.append(n)
            stack.extend(n.children.values())
        for n in reversed(order):
            if n.tier == "device":
                self._remove(n)
            elif n.tier == "host":
                self._drop_host(n)
            else:
                self._drop_disk(n)
        return True

    def _remove(self, node: PrefixNode) -> None:
        del node.parent.children[node.key]
        self._nodes.remove(node)
        self.bytes -= node.nbytes
        self.evictions += 1
        self._evict_counter.inc()
        self._publish()
        # a slab node's device copy frees with the node
        node.k = node.v = None
        if self.on_evict is not None:
            self.on_evict(node)

    def _remove_host(self, node: PrefixNode) -> None:
        """Host-ring victim: demote to the disk ring when possible, drop
        otherwise."""
        if self._disk_admit(node):
            return
        self._drop_host(node)

    def _drop_host(self, node: PrefixNode) -> None:
        del node.parent.children[node.key]
        self._host_nodes.remove(node)
        self.host_bytes -= node.nbytes
        node.host = None
        node.tier = "device"  # detached; a neutral state for late settles
        self.host_evictions += 1
        self.evictions += 1
        self._evict_counter.inc()
        self._publish()
        # a slab node's device copy frees with the node
        node.k = node.v = None
        if self.on_evict is not None:
            self.on_evict(node)

    def _disk_admit(self, node: PrefixNode) -> bool:
        """host -> disk for a landed payload; payloads in flight and
        oversized nodes are not disk-eligible."""
        if self.disk_capacity <= 0 or node.children or node.nbytes > self.disk_capacity:
            return False
        if not is_landed(node.host):
            return False
        while self.disk_bytes + node.nbytes > self.disk_capacity:
            victim = self._lru_leaf(self._disk_nodes)
            if victim is None:
                return False
            self._drop_disk(victim)
        self._disk_seq += 1
        path = os.path.join(self.disk_dir, f"prefix_{node.key:016x}_{self._disk_seq}.npz")
        t0 = time.perf_counter()
        try:
            save_payload(path, node.host)
        except OSError:
            return False
        finally:
            self.disk_s += time.perf_counter() - t0
        self.disk_writes += 1
        node.host = path
        node.tier = "disk"
        self._host_nodes.remove(node)
        self.host_bytes -= node.nbytes
        self._disk_nodes.append(node)
        self.disk_bytes += node.nbytes
        self._publish()
        return True

    def _drop_disk(self, node: PrefixNode) -> None:
        del node.parent.children[node.key]
        self._disk_nodes.remove(node)
        self.disk_bytes -= node.nbytes
        self._unlink_disk(node)
        node.host = None
        node.tier = "device"  # detached; a neutral state for late settles
        self.evictions += 1
        self._evict_counter.inc()
        # a slab node's device copy frees with the node
        node.k = node.v = None
        if self.on_evict is not None:
            self.on_evict(node)

    def _unlink_disk(self, node: PrefixNode) -> None:
        try:
            os.remove(node.host)
        except (OSError, TypeError):
            pass

    # ----------------------------------------------------------------- stats
    def _publish(self) -> None:
        self._bytes_gauge.set(self.bytes)
        self._nodes_gauge.set(len(self._nodes))
        self._host_bytes_gauge.set(self.host_bytes)

    @property
    def num_nodes(self) -> int:
        return len(self._nodes)

    def stats(self) -> Dict[str, Any]:
        """The reference's snapshot, plus ``disk_writes`` (payloads written
        to the disk ring) and ``disk_s`` (host seconds writing and reading
        its files)."""
        return {
            "capacity_bytes": self.capacity,
            "bytes": self.bytes,
            "nodes": len(self._nodes),
            "evictions": self.evictions,
            "host_capacity_bytes": self.host_capacity,
            "host_bytes": self.host_bytes,
            "host_nodes": len(self._host_nodes),
            "host_evictions": self.host_evictions,
            "disk_bytes": self.disk_bytes,
            "disk_nodes": len(self._disk_nodes),
            "spills": self.spills,
            "promotions": self.promotions,
            "disk_writes": self.disk_writes,
            "disk_s": self.disk_s,
        }


__all__ = ["PrefixCache", "PrefixNode", "is_landed", "load_payload", "rolling_hash",
           "save_payload"]
