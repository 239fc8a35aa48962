"""Paged KV pool + block allocator (PagedAttention substrate, paper §3.4).

Device layout (the JAX package's):
  k_pool, v_pool: (L, capacity, block_size, KVH, Dh)

Block 0 is a reserved scratch block (inactive decode slots write there), so
allocatable ids are 1..num_blocks-1. The allocator hands out lowest-index
blocks first so that shrinking can usually drop a free tail; ``resize`` grows
by padding (ids stable) and shrinks only when the tail is free — the engine
compacts or defers otherwise.

Unlike the JAX package's immutable arrays, the pool tensors here are updated
**in place** (block moves, scatters, and the model's KV appends in
``engine/model_exec``), so no step copies a pool.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_codec


def kv_block_bytes(cfg: ModelConfig, block_size: int,
                   dtype_bytes: int = 2) -> int:
    """Device bytes of ONE block across all layers (k+v)."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return 0
    if cfg.mla is not None:
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return L * block_size * width * dtype_bytes          # latent only
    kvh, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return L * block_size * 2 * kvh * dh * dtype_bytes


class BlockAllocator:
    """Lowest-id-first allocator over a heapq free list.

    O(log n) alloc/release (was: full re-sort on every release), so the host
    scheduler stays linear in blocks touched per step."""

    def __init__(self, num_blocks: int):
        # block 0 reserved as scratch; ascending list is already a valid heap
        self.num_blocks = num_blocks
        self.free: List[int] = list(range(1, num_blocks))

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_used(self) -> int:
        return self.num_blocks - 1 - len(self.free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self.free):
            return None
        return [heapq.heappop(self.free) for _ in range(n)]

    def release(self, ids: List[int]) -> None:
        for b in ids:
            assert 0 < b < self.num_blocks
            heapq.heappush(self.free, b)

    def grow(self, new_num_blocks: int) -> None:
        assert new_num_blocks >= self.num_blocks
        # fresh ids exceed every id already in the heap, so appending them
        # preserves the heap invariant (parents are all smaller).
        self.free.extend(range(self.num_blocks, new_num_blocks))
        self.num_blocks = new_num_blocks

    def shrinkable_to(self) -> int:
        """Smallest pool size droppable right now (free tail only).

        Builds a set of the free list (O(len(free))) and walks down from the
        top id while it is free — computed from the free structure alone
        (no set(range(num_blocks)) materialization as before)."""
        if self.n_used == 0:
            return 1
        free_set = set(self.free)
        b = self.num_blocks - 1
        while b in free_set:
            b -= 1
        return b + 1

    def shrink(self, new_num_blocks: int) -> bool:
        if new_num_blocks < self.shrinkable_to():
            return False
        self.free = [b for b in self.free if b < new_num_blocks]
        heapq.heapify(self.free)
        self.num_blocks = new_num_blocks
        return True


class PagedKVPool:
    """Owns the device pool tensors + allocator.

    **Capacity bucketing** (default on): the device tensors are preallocated
    to the power-of-two bucket of the logical block count, and the allocator
    tracks ``num_blocks`` separately. A morph-tick grow/shrink that stays
    within the current bucket is a host-side metadata update — no device
    pool copy, and the pool shape the data plane sees stays fixed.
    Cross-bucket resizes copy exactly once per bucket transition; ``copies``
    counts device pool copies. ``bucket_capacity=False`` gives a
    copy-per-resize pool (capacity == num_blocks at all times).

    The quantized-KV sidecar of the JAX package (int8 mirrors + per-block
    scale/zero) is not ported yet (ROADMAP queue 2). ``qbits``, the host map
    of quantized blocks, is kept so the engine's accounting reads the same;
    it stays empty in real compute, and the device-side quantize/transfer
    methods raise.
    """

    def __init__(self, cfg: ModelConfig, num_blocks: int, block_size: int,
                 dtype=torch.float32, *, bucket_capacity: bool = True,
                 device="cuda"):
        if cfg.mla is not None:
            raise NotImplementedError(
                "MLA latent pools are not ported yet (ROADMAP queue 1)")
        self.cfg = cfg
        self.block_size = block_size
        self.dtype = dtype
        self.device = torch.empty(0, device=device).device
        self.bucket_capacity = bucket_capacity
        self.kvh, self.dh = cfg.n_kv_heads, cfg.resolved_head_dim
        self.capacity = self._cap_bucket(num_blocks)
        self.copies = 0
        shape = (cfg.n_layers, self.capacity, block_size, self.kvh, self.dh)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.alloc = BlockAllocator(num_blocks)
        self.qbits: Dict[int, int] = {}   # block id -> quant width (host map)

    def _cap_bucket(self, n: int) -> int:
        """Physical capacity for ``n`` logical blocks."""
        if not self.bucket_capacity:
            return n
        b = 1
        while b < n:
            b *= 2
        return b

    @property
    def num_blocks(self) -> int:
        return self.alloc.num_blocks

    def usage(self) -> float:
        cap = self.num_blocks - 1
        return self.alloc.n_used / cap if cap else 0.0

    def blocks_for(self, n_tokens: int) -> int:
        if self.cfg.family == "ssm":
            return 0                      # attention-free: state slots only
        return -(-n_tokens // self.block_size)

    def _ids(self, ids: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(ids), dtype=torch.long,
                               device=self.device)

    # ------------------------------------------------------------------
    def resize(self, new_num_blocks: int) -> bool:
        """O(delta) elastic resize. Returns success.

        Within the current capacity bucket this is metadata-only (allocator
        grow / free-tail shrink). Crossing a bucket boundary pads with zero
        blocks / copies the kept head — one device copy per transition.
        """
        old = self.num_blocks
        if new_num_blocks == old:
            return True
        if new_num_blocks > old:
            new_cap = self._cap_bucket(new_num_blocks)
            if new_cap > self.capacity:
                self.k = self._pad(self.k, new_cap)
                self.v = self._pad(self.v, new_cap)
                self.capacity = new_cap
                self.copies += 1
            self.alloc.grow(new_num_blocks)
            return True
        if not self.alloc.shrink(new_num_blocks):
            return False
        new_cap = self._cap_bucket(new_num_blocks)
        if new_cap < self.capacity:
            self.k = self.k[:, :new_cap].contiguous()
            self.v = self.v[:, :new_cap].contiguous()
            self.capacity = new_cap
            self.copies += 1
        return True

    def _pad(self, t: torch.Tensor, new_cap: int) -> torch.Tensor:
        out = torch.zeros((t.shape[0], new_cap) + tuple(t.shape[2:]),
                          dtype=t.dtype, device=t.device)
        out[:, :t.shape[1]] = t
        return out

    # ------------------------------------------------------------------
    # quantized-block host map (the sidecar's device lane is not ported)
    # ------------------------------------------------------------------
    def mark_quantized(self, ids: Sequence[int], bits: int = 8) -> List[int]:
        """Accounting-only quantize (sim compute): tracks which blocks are
        held quantized without touching device tensors. Returns the ids
        actually transitioned (already-quantized ids are skipped)."""
        kv_codec.qmax_for_bits(bits)
        fresh = [b for b in ids if b not in self.qbits]
        for b in fresh:
            self.qbits[b] = bits
        return fresh

    def mark_dequantized(self, ids: Sequence[int]) -> List[int]:
        done = [b for b in ids if b in self.qbits]
        for b in done:
            del self.qbits[b]
        return done

    def clear_quant(self, ids: Sequence[int]) -> List[int]:
        """Forget the quant state of *freed* blocks."""
        return self.mark_dequantized([b for b in ids if b in self.qbits])

    def kv_quant_bundle(self):
        """The kernels' quantized-KV operand bundle: always None here, the
        quantized lane of the kernels is not ported yet."""
        return None

    def _no_quant_lane(self, *_, **__):
        raise NotImplementedError(
            "the quantized-KV lane (pool sidecar + in-kernel dequant) is not "
            "ported yet — ROADMAP queue 2")

    quantize_blocks = dequantize_blocks = _no_quant_lane
    gather_quant_blocks = scatter_quant_blocks = _no_quant_lane

    def move_block(self, src: int, dst: int) -> None:
        """Copy block ``src``'s KV (and its quant-map entry) onto ``dst`` in
        place — tail-compaction support. The caller frees ``src``."""
        self.move_blocks([src], [dst])
        if src in self.qbits:
            self.qbits[dst] = self.qbits.pop(src)

    def move_blocks(self, src: Sequence[int], dst: Sequence[int]) -> None:
        """In-place ``pool[:, dst] = pool[:, src]`` for both pools (device
        contents only; the caller keeps the host maps)."""
        si, di = self._ids(src), self._ids(dst)
        self.k[:, di] = self.k[:, si]
        self.v[:, di] = self.v[:, si]

    # ------------------------------------------------------------------
    # cross-replica state transfer (request migration / prefix migration)
    # ------------------------------------------------------------------
    def gather_blocks(self, ids: Sequence[int]):
        """Copy the listed blocks to host memory: ``(k, v)`` float32 numpy
        arrays of shape ``(L, len(ids), block_size, KVH, Dh)``. The contents
        travel, the ids do not (the importer allocates its own)."""
        idx = self._ids(ids)
        k = self.k[:, idx].to(torch.float32).cpu().numpy()
        v = self.v[:, idx].to(torch.float32).cpu().numpy()
        return k, v

    def scatter_blocks(self, ids: Sequence[int], k, v=None) -> None:
        """Write migrated block contents (numpy or tensors) into
        freshly-allocated local ids, in place."""
        idx = self._ids(ids)
        self.k[:, idx] = torch.as_tensor(np.asarray(k)).to(self.device,
                                                           self.dtype)
        if v is not None:
            self.v[:, idx] = torch.as_tensor(np.asarray(v)).to(self.device,
                                                               self.dtype)


class PrefixCacheEntry:
    """One cached full KV block of a prompt prefix (radix-chain node)."""

    __slots__ = ("key", "parent_key", "block_id", "ref", "children",
                 "last_used", "level", "tol")

    def __init__(self, key: int, parent_key: Optional[int], block_id: int,
                 level: int, now: float, tol: Optional[str] = None):
        self.key = key
        self.parent_key = parent_key
        self.block_id = block_id
        self.level = level            # swap level the KV was computed under
        self.tol = tol                # tolerance tag: None = exact fp at
        #                               `level`; "int8"/"int4" = requantized
        #                               through the KV codec on a hit
        self.ref = 0                  # live requests holding this block
        self.children = 0             # cached entries chained off this one
        self.last_used = now


class PrefixCache:
    """Refcounted shared-prefix KV block cache (radix-style chained hashes).

    Full, block-aligned prompt prefixes are published here on request finish
    instead of being freed: each block is keyed by the chained hash of
    ``(parent_key, block_tokens)``, so a lookup walks the chain from block 0
    and stops at the first miss — longest-prefix match.

    Keys are **level-independent**: the writer's swap level is recorded on
    the entry (``level``), not folded into the hash, so one cached copy per
    prefix serves every level and the cache survives morph transitions —
    exactly when a burst-driven level change would previously have gone
    100% cold. A hit at the writer's level is bit-exact; a *cross-level*
    hit is resolved by the engine's configured policy: adopt the blocks
    as-is (tolerance-tagged on the request — numerically the KV of a
    different precision stack) or requantize them through the shared KV
    codec (entry tagged ``tol="int8"/"int4"``, served via in-kernel
    dequant thereafter).

    Blocks with ``ref == 0`` stay resident but are the cheapest relief tier
    in the engine: they are reclaimed LRU (leaf-first, so chains never dangle
    unreachable interior nodes) before quantize-cold, live-KV shrink,
    preemption, or a quantized layer swap. ``ref > 0`` blocks are pinned —
    copy-on-write is structural: only *full* prefix blocks are ever shared,
    so a holder's writes (later prompt chunks, decode appends) always land
    in its own private blocks past the shared boundary.
    """

    _SEED = 0x9E3779B97F4A7C15          # chain seed (any fixed odd constant)

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.entries: Dict[int, PrefixCacheEntry] = {}
        self.by_block: Dict[int, PrefixCacheEntry] = {}
        # counters (engine/bench observability)
        self.lookups = 0
        self.hits = 0
        self.tokens_reused = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        self.cross_level_hits = 0     # blocks served across a level change
        self.requant_hits = 0         # blocks requantized on a cross hit

    # -- chain keys ------------------------------------------------------
    @classmethod
    def chain_key(cls, prev_key: Optional[int],
                  block_tokens: Sequence[int]) -> int:
        """One chain link: the single place the key formula lives (lookup
        and publish must agree bit-for-bit). Level-independent by design —
        the writer's level lives on the entry, not in the key."""
        return hash((cls._SEED if prev_key is None else prev_key,
                     tuple(block_tokens)))

    def chain_keys(self, tokens: Sequence[int], n_blocks: int) -> List[int]:
        """Chained hashes of the first ``n_blocks`` full blocks."""
        bs = self.block_size
        keys: List[int] = []
        h: Optional[int] = None
        for b in range(n_blocks):
            h = self.chain_key(h, tokens[b * bs:(b + 1) * bs])
            keys.append(h)
        return keys

    # -- stats -----------------------------------------------------------
    @property
    def resident_blocks(self) -> int:
        return len(self.entries)

    @property
    def evictable_blocks(self) -> int:
        return sum(1 for e in self.entries.values() if e.ref == 0)

    # -- lookup / pinning ------------------------------------------------
    def match(self, tokens: Sequence[int], level: int, max_blocks: int,
              now: float) -> List[PrefixCacheEntry]:
        """Longest cached block-aligned prefix of ``tokens``.

        ``level`` is the *reader's* current swap level — it no longer
        restricts the match (keys are level-independent); it classifies
        hit blocks for the counters: an entry written at another level
        counts toward ``cross_level_hits`` and the engine applies its
        adopt / requantize policy to it.

        Matched entries are pinned (ref++) and LRU-touched; the caller owns
        the references and must hand every block back through ``release``.
        """
        self.lookups += 1
        matched: List[PrefixCacheEntry] = []
        for key in self.chain_keys(tokens, max_blocks):
            e = self.entries.get(key)
            if e is None:
                break
            matched.append(e)
        for e in matched:
            e.ref += 1
            e.last_used = now
            if e.level != level:
                self.cross_level_hits += 1
        if matched:
            self.hits += 1
            self.tokens_reused += len(matched) * self.block_size
        return matched

    def peek(self, tokens: Sequence[int],
             max_blocks: int) -> List[PrefixCacheEntry]:
        """Longest cached block-aligned prefix *without* pinning, touching
        LRU stamps, or counting a lookup — the read-only probe the cluster
        uses to decide whether a peer replica's cache is worth migrating."""
        matched: List[PrefixCacheEntry] = []
        for key in self.chain_keys(tokens, max_blocks):
            e = self.entries.get(key)
            if e is None:
                break
            matched.append(e)
        return matched

    def release(self, block_id: int, now: float) -> bool:
        """Drop one reference to a cached block. Returns True when the block
        belongs to the cache (the caller must NOT free it to the allocator);
        False means the block is not cached and stays caller-owned."""
        e = self.by_block.get(block_id)
        if e is None:
            return False
        assert e.ref > 0, f"release of unpinned cached block {block_id}"
        e.ref -= 1
        e.last_used = now
        return True

    # -- publish ---------------------------------------------------------
    def insert(self, key: int, parent_key: Optional[int], block_id: int,
               level: int, now: float, tol: Optional[str] = None) -> bool:
        """Publish a finished request's private full block (``level`` =
        the swap level its KV was computed under; ``tol`` carries a
        tolerance tag for non-exact content). Returns True when the cache
        took ownership (resident at ref 0); False when the key or block is
        already cached — first writer wins (one copy per prefix now that
        keys are level-independent) and the caller keeps/frees the block."""
        if key in self.entries or block_id in self.by_block:
            return False
        if parent_key is not None and parent_key not in self.entries:
            return False                      # chain broken: parent evicted
        e = PrefixCacheEntry(key, parent_key, block_id, level, now, tol)
        self.entries[key] = e
        self.by_block[block_id] = e
        if parent_key is not None:
            self.entries[parent_key].children += 1
        self.inserted_blocks += 1
        return True

    def requantize_entry(self, e: PrefixCacheEntry, level: int,
                         bits: int) -> None:
        """Record a requantize-on-hit: the entry's content went through the
        shared KV codec (the caller performed the pool-side quantize), so
        it now serves every level via in-kernel dequant — tagged, and
        re-homed at the requesting level."""
        e.level = level
        e.tol = f"int{bits}"
        self.requant_hits += 1

    # -- eviction (tier-1 relief) ----------------------------------------
    def _drop(self, e: PrefixCacheEntry) -> int:
        del self.entries[e.key]
        del self.by_block[e.block_id]
        if e.parent_key is not None:
            parent = self.entries.get(e.parent_key)
            if parent is not None:
                parent.children -= 1
        self.evicted_blocks += 1
        return e.block_id

    def evict_lru(self, n: int) -> List[int]:
        """Reclaim up to ``n`` idle cached blocks, least-recently-used leaves
        first. Returns the freed block ids (caller releases to allocator)."""
        freed: List[int] = []
        heap = [(e.last_used, e.key) for e in self.entries.values()
                if e.ref == 0 and e.children == 0]
        heapq.heapify(heap)
        while heap and len(freed) < n:
            _, key = heapq.heappop(heap)
            e = self.entries.get(key)
            if e is None or e.ref or e.children:
                continue
            parent = (self.entries.get(e.parent_key)
                      if e.parent_key is not None else None)
            freed.append(self._drop(e))
            # an interior node becomes evictable once its last child goes
            if parent is not None and parent.ref == 0 \
                    and parent.children == 0:
                heapq.heappush(heap, (parent.last_used, parent.key))
        return freed

    def evict_block_ids_at_or_above(self, limit: int) -> List[int]:
        """Reclaim idle cached blocks with id >= ``limit`` (pool-shrink
        support: the free tail must really be free). Pinned blocks up there
        block the shrink — the engine defers, as for any live block."""
        freed: List[int] = []
        while True:
            doomed = [e for e in self.entries.values()
                      if e.ref == 0 and e.children == 0
                      and e.block_id >= limit]
            if not doomed:
                return freed
            for e in doomed:
                freed.append(self._drop(e))

    # -- invariants (tests) ----------------------------------------------
    def check(self, alloc: "BlockAllocator") -> None:
        free = set(alloc.free)
        child_counts: Dict[int, int] = {}
        for e in self.entries.values():
            assert self.by_block[e.block_id] is e
            assert e.block_id not in free, \
                f"cached block {e.block_id} is also on the free list"
            assert e.ref >= 0
            if e.parent_key is not None:
                assert e.parent_key in self.entries, \
                    f"entry {e.key} dangles off evicted parent"
                child_counts[e.parent_key] = \
                    child_counts.get(e.parent_key, 0) + 1
        for key, e in self.entries.items():
            assert e.children == child_counts.get(key, 0)
        assert len(self.by_block) == len(self.entries)
