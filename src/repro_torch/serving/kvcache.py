"""Paged KV cache: the port of ``repro.serving.kvcache`` for the fp, int8
and int4 tiers and MLA's compressed streams.

* ``BlockAllocator`` — host-side metadata for a pool of fixed-size token
  blocks: refcounted sharing (copy-on-write via ``ensure_writable``), a
  hash-based prefix registry over full prompt blocks, and an LRU
  "cached-free" list so freed-but-registered blocks survive until memory
  pressure evicts them. Pure Python, the same as the JAX package's.
* ``PagedKVCache`` — the device pools plus the block tables. The pools keep
  the port's per-layer layout, ``{"layers": [(k_pool, v_pool), ...]}`` with
  each pool ``[N, block_size, Hkv, hd]`` (int8 tier: ``(k_pool, k_scale,
  v_pool, v_scale)`` with f32 scale pools ``[N, block_size, Hkv]``; int4
  tier: packed pools ``[N, block_size, Hkv, hd // 2]`` with f16 group-scale
  pools ``[N, block_size, Hkv, hd // g]``; MLA: the head-free ``(c_pool
  [N, block_size, rank], r_pool [N, block_size, dr])``; an MoE model keeps
  its ``head_layers`` pools beside ``layers``), and are written in place
  (the JAX package replaces them functionally). ``tables`` is rebuilt only when
  a slot's blocks change, with one host-to-device copy.
* ``SharedKVPool`` — one allocator and one set of pools, which several
  engines attach to (``PagedKVCache(shared=)``) for disaggregated serving:
  a prefill worker exports a prompt's blocks as a ``KVHandoff``
  (``export_blocks``) and a decode worker attaches them to a slot
  (``import_blocks``) with no recompute. Every engine on a store writes the
  same pool tensors in place, so a peer sees a write as soon as the stream
  it was issued on reaches it; the engines of one process share one stream.
* Tensor-parallel serving (``shards`` > 1): the store holds one pool tree
  per shard (``shard_pools``; GQA leaves hold the shard's kv-head slice,
  MLA leaves a whole copy). Block ids, tables and the allocator stay one,
  host-side: sharding never changes a block's identity, only where its
  payload lives, and every pool operation acts on every shard.

``truncate`` is the speculative-decoding rollback. Also here: copies of
``pow2_bucket`` and ``bucketed_prefill_ok``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.quantize import kv_group_size
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.transformer import (kv_leaves, layer_caches,
                                            stack_sizes)

#: table entries below 0 mean "no block allocated"; gathers clamp to the
#: reserved trash block 0 and mask by position validity.
NO_BLOCK = -1
#: block id 0 is reserved: padded scatter writes land there harmlessly and
#: clamped gathers of unallocated table entries read from it (masked out).
TRASH_BLOCK = 0


def paged_supported(cfg: ModelConfig) -> Optional[str]:
    """Why ``cfg`` cannot use the paged cache, or None if it can: the JAX
    package's gate and reasons, except that a vlm is served (an
    attention-only stack whose frontend rows the blocks hold like tokens;
    the JAX package refuses it with the recurrent stacks' reason)."""
    if cfg.arch_type not in ("dense", "moe", "vlm"):
        return f"arch_type {cfg.arch_type!r} has non-attention caches"
    if cfg.window:
        return "sliding-window attention keeps the dense ring-buffer cache"
    if cfg.n_codebooks > 1:
        return "multi-codebook models keep the dense cache"
    return None


def bucketed_prefill_ok(cfg: ModelConfig) -> bool:
    """Whether prefill may pad *tokens* (not just the cache) to a bucket:
    dense full-attention single-codebook models only. Pad tokens trail the
    real ones, so causal attention keeps them out of every real position."""
    return (cfg.arch_type == "dense" and not cfg.window
            and cfg.n_codebooks <= 1)


def pow2_bucket(n: int, floor: int = 16) -> int:
    """Next power-of-two >= n (min ``floor``): the shared padding bucket."""
    n = max(int(n), 1)
    return max(floor, 1 << (n - 1).bit_length())


def hash_prompt_blocks(tokens: Sequence[int], block_size: int,
                       salt: Any = None) -> List[int]:
    """Chained content hashes, one per FULL block of ``tokens``: block i's
    hash covers tokens[0 : (i+1)*block_size], so equal hashes imply equal
    prefixes (up to collisions of Python's tuple hash)."""
    out: List[int] = []
    h = hash(("kv-prefix", salt))
    for i in range(len(tokens) // block_size):
        h = hash((h, tuple(tokens[i * block_size:(i + 1) * block_size])))
        out.append(h)
    return out


@dataclasses.dataclass
class AllocatorStats:
    allocated: int = 0            # total successful alloc() calls
    evictions: int = 0            # cached blocks dropped for reuse
    cow_copies: int = 0           # copy-on-write block duplications
    peak_in_use: int = 0          # high-water mark of referenced blocks

    def reset(self) -> None:
        self.allocated = self.evictions = self.cow_copies = 0
        self.peak_in_use = 0


class BlockAllocator:
    """Host-side metadata for ``n_blocks`` fixed-size KV blocks.

    Invariants:
      * a block is in exactly one of: free list, cached LRU (refcount 0 but
        hash-registered), or in use (refcount >= 1);
      * ``lookup`` revives cached blocks (refcount 0 -> 1);
      * eviction only touches the cached LRU — referenced blocks are never
        reclaimed (callers preempt requests to create free blocks).
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # block 0 is the reserved trash block — never handed out
        self._free: deque = deque(range(1, n_blocks))
        self._ref: List[int] = [0] * n_blocks
        self._hash: List[Optional[int]] = [None] * n_blocks
        self._by_hash: Dict[int, int] = {}            # live hash -> block
        self._cached: "OrderedDict[int, int]" = OrderedDict()  # hash -> block (LRU)
        self.stats = AllocatorStats()

    # ------------------------------------------------------------- #
    @property
    def usable_blocks(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cached(self) -> int:
        return len(self._cached)

    @property
    def in_use(self) -> int:
        return self.usable_blocks - self.n_free - self.n_cached

    def available(self) -> int:
        """Blocks obtainable without preempting anyone (free + evictable)."""
        return self.n_free + self.n_cached

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    # ------------------------------------------------------------- #
    def alloc(self) -> Optional[int]:
        """One fresh block (refcount 1, no hash), or None when exhausted.
        Prefers truly-free blocks; otherwise evicts the LRU cached block."""
        if self._free:
            bid = self._free.popleft()
        elif self._cached:
            h, bid = self._cached.popitem(last=False)      # LRU eviction
            del self._by_hash[h]
            self._hash[bid] = None
            self.stats.evictions += 1
        else:
            return None
        self._ref[bid] = 1
        self.stats.allocated += 1
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.in_use)
        return bid

    def retain(self, bid: int) -> int:
        """refcount++ (sharing an existing block)."""
        assert self._ref[bid] >= 1, f"retain of unreferenced block {bid}"
        self._ref[bid] += 1
        return bid

    def free(self, bid: int) -> None:
        """refcount--; at zero the block returns to the cached LRU when it
        carries a registered hash (reusable prefix), else to the free list."""
        assert self._ref[bid] >= 1, f"double free of block {bid}"
        self._ref[bid] -= 1
        if self._ref[bid]:
            return
        h = self._hash[bid]
        if h is not None and self._by_hash.get(h) == bid:
            self._cached[h] = bid
        else:
            if h is not None:
                self._hash[bid] = None
            self._free.append(bid)

    # ------------------------------------------------------------- #
    def register(self, bid: int, h: int) -> None:
        """Publish ``bid`` as the cached block for prefix hash ``h``. An
        existing mapping for ``h`` wins (first writer keeps serving the
        prefix). A block carries at most ONE hash: re-registering a block
        under a new hash retires its old mapping, so ``lookup(old)`` never
        attaches content that no longer matches it."""
        old = self._hash[bid]
        if old is not None and old != h and self._by_hash.get(old) == bid:
            del self._by_hash[old]
            self._hash[bid] = None
        if h in self._by_hash:
            return
        self._by_hash[h] = bid
        self._hash[bid] = h

    def peek(self, h: int) -> Optional[int]:
        """Non-mutating prefix probe: the block registered for ``h`` (no
        refcount bump, no LRU reordering, no stats). Admission sizes a
        request with it, so a failed probe leaves the allocator unchanged."""
        return self._by_hash.get(h)

    def lookup(self, h: int) -> Optional[int]:
        """Prefix hit: returns the block for ``h`` with refcount bumped
        (reviving it from the cached LRU if needed), else None."""
        bid = self._by_hash.get(h)
        if bid is None:
            return None
        if self._ref[bid] == 0:
            self._cached.pop(h, None)                      # revive
            self._ref[bid] = 1
            self.stats.peak_in_use = max(self.stats.peak_in_use, self.in_use)
        else:
            self._ref[bid] += 1
        return bid

    def ensure_writable(self, bid: int) -> Tuple[int, bool]:
        """Copy-on-write: a block shared with other tables (refcount > 1) or
        published in the prefix registry must not be mutated in place.
        Returns ``(writable_bid, needs_copy)``; when ``needs_copy`` the
        caller copies the pool contents from ``bid`` to the new id. The
        scheduler only shares FULL blocks and decode writes into freshly
        grown private blocks, so it never needs this today."""
        if self._ref[bid] == 1 and self._hash[bid] is None:
            return bid, False
        new = self.alloc()
        if new is None:
            raise MemoryError("no block available for copy-on-write")
        self.free(bid)
        self.stats.cow_copies += 1
        return new, True

    def reset(self) -> None:
        """Drop every table, hash and cached block (engine warmup uses this
        so measurement runs start cold)."""
        self._free = deque(range(1, self.n_blocks))
        self._ref = [0] * self.n_blocks
        self._hash = [None] * self.n_blocks
        self._by_hash.clear()
        self._cached.clear()
        self.stats.reset()


# ------------------------------------------------------------------ #
# Device-side pools
# ------------------------------------------------------------------ #
def init_paged_pools(cfg: ModelConfig, n_blocks: int, block_size: int,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Zeroed block pools per layer: ``(k_pool, v_pool)``, each
    ``[n_blocks, block_size, Hkv, hd]`` in the activation dtype, or for the
    quantized tiers ``(k_pool, k_scale, v_pool, v_scale)``: int8 pools with
    f32 ``[n_blocks, block_size, Hkv]`` scale pools, int4 pools
    ``[n_blocks, block_size, Hkv, hd // 2]`` with f16
    ``[n_blocks, block_size, Hkv, hd // g]`` group-scale pools; MLA:
    ``(c_pool [n_blocks, block_size, rank], r_pool [..., dr])``: the dense
    cache's leaves with one shared pool in place of per-slot reservations,
    stack by stack (``head_layers`` then ``layers`` for an MoE model). A
    config the port does not serve raises, naming its ROADMAP item."""
    check_supported(cfg)
    why = paged_supported(cfg)
    if why is not None:
        raise ValueError(f"paged KV cache unsupported for {cfg.name}: {why}")
    dev = resolve_device(device)
    return {key: [kv_leaves(cfg, (n_blocks, block_size), dev)
                  for _ in range(n)]
            for key, n in stack_sizes(cfg).items()}


def _pool_tensors(pools) -> List[torch.Tensor]:
    return [t for leaves in layer_caches(pools) for t in leaves]


def _shard_pool_tensors(shard_pools) -> List[torch.Tensor]:
    """Every pool tensor of every shard."""
    return [t for pools in shard_pools for t in _pool_tensors(pools)]


def _unsharded(tree) -> List[Any]:
    """An unsharded store's ``pool_sharding``: the one tree."""
    return [tree]


def kv_pool_signature(cfg: ModelConfig, n_blocks: int,
                      block_size: int) -> Tuple:
    """Geometry + precision fingerprint of a block pool. Two engines may
    share one ``SharedKVPool`` only when their configs give identical
    signatures: block ids are raw indices into the pool tensors, so a shape
    or dtype mismatch would read garbage, not raise."""
    return (cfg.attention, cfg.n_layers, cfg.n_dense_layers if cfg.n_experts
            else 0, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.kv_lora_rank,
            cfg.qk_rope_dim, cfg.kv_precision, str(cfg.activation_dtype),
            n_blocks, block_size)


class SharedKVPool:
    """One allocator plus one set of device pools. An engine builds its own
    store unless it is given one; several engines given the same store
    (disaggregated prefill / decode workers) see the same blocks: each
    ``PagedKVCache`` keeps its own slots and tables and delegates ``alloc``
    and ``pools`` here.

    ``shard_pools`` is the list of per-shard pool trees, the form the
    engine's entry points take: one tree unless ``shards`` > 1
    (tensor-parallel engines), where ``pool_sharding`` (a
    ``TPContext.shard_cache``) splits the pools into one tree per shard.
    ``pools`` is shard 0's tree (the whole pool when unsharded)."""

    def __init__(self, cfg: ModelConfig, n_blocks: int, block_size: int,
                 device: DeviceLike = None, *, shards: int = 1,
                 pool_sharding: Optional[Callable] = None):
        self.cfg = cfg
        self.block_size = block_size
        self.device = resolve_device(device)
        self.shards = max(int(shards), 1)
        self.signature = kv_pool_signature(cfg, n_blocks, block_size)
        self.alloc = BlockAllocator(n_blocks, block_size)
        self.pool_sharding = pool_sharding or _unsharded
        self.shard_pools = list(self.pool_sharding(
            init_paged_pools(cfg, n_blocks, block_size, self.device)))
        if len(self.shard_pools) != self.shards:
            raise ValueError(f"shards={self.shards} needs a pool_sharding "
                             f"giving as many trees, not "
                             f"{len(self.shard_pools)}")

    @property
    def pools(self):
        """Shard 0's pool tree (the whole pool when unsharded)."""
        return self.shard_pools[0]

    def reset(self) -> None:
        """Drop all allocator state. Only safe when every attached engine is
        idle: the router releases all slots first."""
        self.alloc.reset()


@dataclasses.dataclass
class KVHandoff:
    """Ownership token for a prompt's KV blocks, made by a prefill worker
    and consumed by a decode worker on the same store.

    The prefill engine retains every block before releasing its slot, so
    the blocks stay live (refcount >= 1) with the handoff as their owner.
    Full prompt blocks are also hash-registered, so a handoff that is
    dropped still leaves its prefix as cache. Exactly one of consume (a
    decode slot's table takes the references) and ``release`` (they are
    dropped) must run."""

    tokens: Any                      # [1, S] prompt on the engine device
    first_token: int                 # the one token the prefill step sampled
    block_ids: Tuple[int, ...]       # pool blocks, prompt order
    cache_pos: int                   # positions in the cache (== prompt len)
    block_hashes: Tuple[int, ...]    # chained hashes of the full blocks
    consumed: bool = False

    def release(self, alloc: BlockAllocator) -> None:
        """Drop the handoff's ownership (request cancelled, or rejected for
        good). Registered blocks fall back to the cached LRU; the partial
        tail block returns to the free list."""
        if self.consumed:
            return
        self.consumed = True
        for bid in self.block_ids:
            alloc.free(bid)


class PagedKVCache:
    """Pools + allocator + block tables for ``n_slots`` decode slots.

    ``tables`` is ``[n_slots, max_blocks]`` int32 on the pools' device
    (NO_BLOCK where unallocated); the host-side ``slot_blocks`` lists are
    authoritative and the tensor is rebuilt only after they change, so the
    decode loop copies nothing to the device on a step that grows no slot."""

    def __init__(self, cfg: ModelConfig, n_slots: int, n_blocks: int,
                 block_size: int, max_blocks_per_seq: int, *,
                 shards: int = 1, pool_sharding: Optional[Callable] = None,
                 shared: Optional[SharedKVPool] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_blocks = max_blocks_per_seq
        self.device = resolve_device(device)
        if shared is not None:
            sig = kv_pool_signature(cfg, shared.alloc.n_blocks,
                                    shared.block_size)
            if sig != shared.signature:
                raise ValueError(
                    "engine config incompatible with the shared KV pool: "
                    f"{sig} != {shared.signature}")
            if shared.device != self.device:
                raise ValueError(f"the shared KV pool is on {shared.device}, "
                                 f"the engine on {self.device}")
            self.store = shared
            self.owns_store = False
        else:
            self.store = SharedKVPool(cfg, n_blocks, block_size, self.device,
                                      shards=shards,
                                      pool_sharding=pool_sharding)
            self.owns_store = True
        self.block_size = self.store.block_size
        # tensor-parallel serving: each shard holds its kv-head slice of
        # every pool leaf; tables, the allocator and the slots stay one
        self.shards = self.store.shards
        self.alloc = self.store.alloc
        self.slot_blocks: List[List[int]] = [[] for _ in range(n_slots)]
        self._tables: Optional[torch.Tensor] = None
        if self.bytes_per_block * self.alloc.usable_blocks <= 0:
            raise ValueError("empty paged pool")

    # ------------------------------------------------------------- #
    @property
    def shard_pools(self) -> List[Any]:
        """The store's per-shard pool trees (one unless ``shards`` > 1):
        every engine on a shared store writes these same tensors in place
        (nothing rebinds them)."""
        return self.store.shard_pools

    @property
    def pools(self):
        """Shard 0's pool tree (the whole pool when unsharded)."""
        return self.store.pools

    @property
    def bytes_per_block_per_shard(self) -> int:
        """Device bytes one shard pays per block (== ``bytes_per_block``
        for tp=1 and for MLA pools, which every shard holds whole)."""
        n = self.alloc.n_blocks
        return sum(t.numel() * t.element_size() // n
                   for t in _pool_tensors(self.pools))

    @property
    def bytes_per_block(self) -> int:
        """Pool bytes per block over the whole model: a shard's bytes times
        the ways the payload splits (a replicated MLA pool counts once, as
        ``nbytes`` of a sharded jax.Array counts it)."""
        return self.bytes_per_block_per_shard * kv_shard_divisor(
            self.cfg, self.shards)

    @property
    def bytes_per_token(self) -> int:
        return self.bytes_per_block // self.block_size

    def kv_bytes_in_use(self, blocks: Optional[int] = None) -> int:
        n = self.alloc.in_use if blocks is None else blocks
        return n * self.bytes_per_block

    def kv_bytes_in_use_per_shard(self, blocks: Optional[int] = None) -> int:
        n = self.alloc.in_use if blocks is None else blocks
        return n * self.bytes_per_block_per_shard

    @property
    def tables(self) -> torch.Tensor:
        if self._tables is None:
            rows = [blocks + [NO_BLOCK] * (self.max_blocks - len(blocks))
                    for blocks in self.slot_blocks]
            t = torch.tensor(rows, dtype=torch.int32)
            if self.device.type == "cuda":
                # pinned source: the copy is queued on the stream without
                # waiting for the card
                t = t.pin_memory().to(self.device, non_blocking=True)
            self._tables = t
        return self._tables

    def _dirty(self) -> None:
        self._tables = None

    # ------------------------------------------------------------- #
    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def attach(self, slot: int, bid: int) -> None:
        blocks = self.slot_blocks[slot]
        if len(blocks) >= self.max_blocks:
            raise MemoryError(f"slot {slot} exceeds max_blocks {self.max_blocks}")
        blocks.append(bid)
        self._dirty()

    def grow(self, slot: int) -> bool:
        """Allocate + attach one block; False when the pool is exhausted
        (caller preempts a victim and retries)."""
        bid = self.alloc.alloc()
        if bid is None:
            return False
        self.attach(slot, bid)
        return True

    def truncate(self, slot: int, keep_blocks: int) -> int:
        """Speculative-decoding rollback: free ``slot``'s tail blocks beyond
        the first ``keep_blocks`` (blocks that only ever held rejected
        verify writes). Tail blocks are private (grown fresh for decode,
        never hash-registered), so they go straight back to the free list.
        Returns the number of blocks released."""
        blocks = self.slot_blocks[slot]
        n = 0
        while len(blocks) > keep_blocks:
            self.alloc.free(blocks.pop())
            n += 1
        if n:
            self._dirty()
        return n

    def release_slot(self, slot: int) -> None:
        for bid in self.slot_blocks[slot]:
            self.alloc.free(bid)
        self.slot_blocks[slot] = []
        self._dirty()

    def make_writable(self, slot: int, idx: int) -> None:
        """Copy-on-write the ``idx``-th block of ``slot`` if it is shared
        or published; pool contents are copied block to block."""
        bid = self.slot_blocks[slot][idx]
        new, copied = self.alloc.ensure_writable(bid)
        if copied:
            for t in _shard_pool_tensors(self.shard_pools):
                t[new].copy_(t[bid])
            self.slot_blocks[slot][idx] = new
            self._dirty()

    # ------------------------------------------------------------- #
    def scatter_prefill(self, slot: int, dense_cache: Any,
                        n_tokens: int) -> List[int]:
        """Move a dense batch-1 prefill cache (per-layer leaves of
        ``[1, S_pad, ...]``, in the pools' order) into freshly allocated
        blocks for ``slot``; a sharded store splits it as its pools."""
        need = self.blocks_for_tokens(n_tokens)
        ids = []
        for _ in range(need):
            bid = self.alloc.alloc()
            if bid is None:
                for b in ids:
                    self.alloc.free(b)
                raise MemoryError("pool exhausted during prefill scatter")
            ids.append(bid)
        bs = self.block_size
        idx = torch.tensor(ids, dtype=torch.int64, device=self.device)
        for pool, d in zip(_shard_pool_tensors(self.shard_pools),
                           _shard_pool_tensors(
                               self.store.pool_sharding(dense_cache))):
            rows = d[0, :need * bs]
            if rows.shape[0] < need * bs:
                pad = need * bs - rows.shape[0]
                rows = torch.cat([rows, rows.new_zeros(
                    (pad,) + tuple(rows.shape[1:]))])
            pool[idx.to(pool.device)] = rows.reshape(
                (need, bs) + tuple(rows.shape[1:])).to(pool.dtype)
        for bid in ids:
            self.attach(slot, bid)
        return ids

    # ------------------------------------------------------------- #
    def export_blocks(self, slot: int) -> Tuple[int, ...]:
        """Retain and return ``slot``'s blocks for a handoff. One reference
        per block moves to the caller; the slot keeps its own until
        ``release_slot`` drops them."""
        ids = tuple(self.slot_blocks[slot])
        for bid in ids:
            self.alloc.retain(bid)
        return ids

    def import_blocks(self, slot: int, ids: Sequence[int]) -> None:
        """Attach exported blocks to an (empty) slot's table. The caller's
        references move to the table: no refcount change."""
        assert not self.slot_blocks[slot], f"slot {slot} not empty"
        for bid in ids:
            assert self.alloc.refcount(bid) >= 1, f"import of freed block {bid}"
            self.attach(slot, bid)

    def reset(self) -> None:
        """Engine warmup / teardown: drop every slot, hash and cached block.
        An engine on a shared store drops only its own slots: resetting the
        allocator under its peers would corrupt their tables (the router
        resets the store once, after every engine is idle)."""
        if self.owns_store:
            self.alloc.reset()
        else:
            for slot in range(self.n_slots):
                self.release_slot(slot)
        self.slot_blocks = [[] for _ in range(self.n_slots)]
        self._dirty()


# ------------------------------------------------------------------ #
# Sizing helpers (memory accounting)
# ------------------------------------------------------------------ #
def kv_shard_divisor(cfg: ModelConfig, shards: int = 1) -> int:
    """How many ways the cache payload splits under ``shards``-way tensor
    parallelism: GQA caches shard on the kv-head axis, MLA latent caches
    are head-free and every shard holds them whole (divisor 1), and so
    does a kv-head count the shards do not divide."""
    if shards <= 1 or cfg.attention == "mla":
        return 1
    if cfg.n_kv_heads % shards:
        return 1
    return shards


def kv_bytes_per_token(cfg: ModelConfig, shards: int = 1) -> int:
    """Per-token, per-layer KV bytes for ``cfg``'s resolved precision tier:
    the accounting rule shared by ``kv_bytes_per_block`` and the engine's
    ``kv_hbm_bytes_per_req``.

        mla    (kv_lora_rank + qk_rope_dim) * itemsize   (no quantized tier)
        fp     2 * Hkv * hd * itemsize
        int8   2 * Hkv * (hd + 4)                 payload + per-head f32 scale
        int4   2 * Hkv * (hd/2 + 2 * n_groups)    nibbles + f16 group scales

    ``shards`` > 1 gives the *per-shard* bytes under tensor parallelism:
    GQA tiers carry ``Hkv / shards`` local heads (payload and scale rows
    both ride the head axis, so every tier divides exactly); MLA caches
    keep their full size on every shard.
    """
    itemsize = torch.empty((), dtype=cfg.activation_dtype).element_size()
    if cfg.attention == "mla":
        return int((cfg.kv_lora_rank + cfg.qk_rope_dim) * itemsize)
    hd = cfg.resolved_head_dim
    hkv = cfg.n_kv_heads // kv_shard_divisor(cfg, shards)
    prec = cfg.kv_precision
    if prec == "int4":
        return int(2 * hkv * (hd // 2 + 2 * (hd // kv_group_size(hd))))
    if prec == "int8":
        return int(2 * hkv * (hd + 4))
    return int(2 * hkv * hd * itemsize)


def kv_bytes_per_block(cfg: ModelConfig, block_size: int,
                       shards: int = 1) -> int:
    """Per-block bytes across all layers (with ``shards`` > 1: the bytes
    each shard's device pays per block)."""
    return int(cfg.n_layers * block_size * kv_bytes_per_token(cfg, shards))


def blocks_for_budget(cfg: ModelConfig, block_size: int,
                      budget_bytes: int, floor: int = 2,
                      shards: int = 1) -> int:
    """How many pool blocks fit a byte budget (>= ``floor`` usable). The
    budget is per *device*: under tensor parallelism each device holds
    only its head shard of every block, so the same budget admits up to
    ``shards`` x more blocks (MLA pools: no gain)."""
    per = kv_bytes_per_block(cfg, block_size, shards)
    return max(floor + 1, budget_bytes // max(per, 1))
