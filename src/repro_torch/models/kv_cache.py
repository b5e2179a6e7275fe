"""Decode-time KV cache and the slot arena for continuous batching.

Counterpart of `repro/models/kv_cache.py`. The cache is a dict of
tensors: k/v (L, B, T, KV, dh), kv_pos (B, T) absolute position of each
slot (-1 = empty) and length (B,). A full cache has a slot per position;
the sliding-window (ring) cache has T = window slots, token `pos` in
slot pos % T. Unlike the reference's immutable
arrays, writes here update the tensors in place (no copy of the cache per
token); every caller hands the cache on and never reuses an old one.

Every write goes to slot `pos % T`. Freed arena slots keep decoding as
"zombie" lanes whose length keeps growing past T; JAX clamps an
out-of-range update, torch indexing would raise, so the modulo keeps
such lanes in range.
"""
from __future__ import annotations

import torch


def init_full_cache(n_layers, batch, s_max, kv_heads, d_head, dtype,
                    device):
    return {
        "k": torch.zeros((n_layers, batch, s_max, kv_heads, d_head),
                         dtype=dtype, device=device),
        "v": torch.zeros((n_layers, batch, s_max, kv_heads, d_head),
                         dtype=dtype, device=device),
        "kv_pos": torch.full((batch, s_max), -1, dtype=torch.int32,
                             device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def init_ring_cache(n_layers, batch, seq_len, window, kv_heads, d_head,
                    dtype, device):
    """The self-attention cache of `seq_len` positions under a sliding
    `window` (0: none): a ring of `window` slots per row, token `pos` in
    slot pos % window with kv_pos its absolute position (-1 = empty),
    when the window is the shorter, else a full cache of `seq_len`
    slots. seq_len None gives the ring whatever the length."""
    T = window if seq_len is None or (window and window < seq_len) \
        else seq_len
    return init_full_cache(n_layers, batch, T, kv_heads, d_head, dtype,
                           device)


def cache_slot(cache_k_layer, pos):
    """Write slot of each batch row, pos (B,) -> pos % T, T the cache's
    slots (dim 1): the ring's slot, and `pos` itself in a full cache."""
    return (pos % cache_k_layer.shape[1]).long()


def prefill_slots(S: int, window: int, max_len=None):
    """(slots T, tokens kept n) of the cache a prefill of S tokens fills:
    with a window W < S the ring of W slots keeping the last W tokens,
    token p in slot p % W, so S must be a multiple of W (it raises
    otherwise); else `max_len` (default S) slots keeping all S."""
    if window and window < S:
        if S % window:
            raise ValueError(f"prefill length {S} must be a multiple of "
                             f"the ring window {window}")
        return window, window
    return max_len or S, S


def write_prefill(cache, kvs, S: int, n: int, keys=("k", "v")):
    """Write the last n of the S prefill tokens' k / v (each layer's (B,
    S, KV, dh) in `kvs`) into the first n slots of cache[keys] (L, B, T,
    KV, dh), their positions into kv_pos, and S into length."""
    for l, (k, v) in enumerate(kvs):
        cache[keys[0]][l, :, :n] = k[:, S - n:]
        cache[keys[1]][l, :, :n] = v[:, S - n:]
    cache["kv_pos"][:, :n] = torch.arange(S - n, S, dtype=torch.int32,
                                          device=cache["kv_pos"].device)
    cache["length"].fill_(S)
    return cache


def write_kv(k_layer, v_layer, k_new, v_new, pos):
    """Insert one token per batch row at slot pos % T, in place.
    k_layer (B, T, KV, dh); k_new (B, 1, KV, dh); pos (B,)."""
    rows = torch.arange(k_layer.shape[0], device=k_layer.device)
    slot = cache_slot(k_layer, pos)
    k_layer[rows, slot] = k_new[:, 0]
    v_layer[rows, slot] = v_new[:, 0]
    return k_layer, v_layer


def write_pos(kv_pos, pos):
    """Record the absolute position `pos` (B,) at slot pos % T, in place."""
    rows = torch.arange(kv_pos.shape[0], device=kv_pos.device)
    kv_pos[rows, cache_slot(kv_pos, pos)] = pos.to(kv_pos.dtype)
    return kv_pos


# the fresh state of a slot: no keys or values, every position empty
_FRESH = {"k": 0, "v": 0, "kv_pos": -1, "length": 0}
_SLOT_DIM = {"k": 1, "v": 1, "kv_pos": 0, "length": 0}


class KVSlotArena:
    """Fixed-slot KV arena with a free list (continuous batching).

    Physical layout is the ordinary full cache — (L, capacity, T, KV, dh)
    buffers — but rows are *slots* owned by live requests. The buffers
    are allocated at `capacity` rows (the largest bucket the engine's
    submitted work can reach) and move only when `grow` enlarges them:
    the cache of a bucket of n slots is the view of rows [0, n)
    (`cache`), so each layer's `cache["k"][l]` stays contiguous and a
    CUDA graph captured on a bucket's views reads the same storage at
    every replay until the next `grow`. Admitting a request writes its
    prefilled KV into a free slot (live rows untouched); completion
    returns the slot to the free list. Freed slots keep decoding as
    masked "zombie" lanes whose outputs are ignored, so the decode shape
    never changes inside a bucket. `resize`, the only operation that
    changes the view, runs only at decoder bucket-boundary crossings.

    Memory: capacity x T x L x 2 x KV x dh x itemsize bytes; at
    smollm-135m's full width (30 layers, 3 KV heads of 64, bf16) 23,040
    bytes per slot and position: 94 MB at 64 slots of 64 positions, 47
    MB at one slot of 2,048, 3.0 GB at 64 slots of 2,048.
    """

    def __init__(self, n_layers, n_slots, max_len, kv_heads, d_head, dtype,
                 device, capacity: int = None):
        capacity = n_slots if capacity is None else capacity
        if not 0 < n_slots <= capacity:
            raise ValueError(f"{n_slots} slots do not fit an arena of "
                             f"{capacity}")
        self.dims = (n_layers, kv_heads, d_head)
        self.max_len = max_len
        self.dtype = dtype
        self.device = device
        self.storage = init_full_cache(n_layers, capacity, max_len,
                                       kv_heads, d_head, dtype, device)
        self._set_view(n_slots)
        self.free = list(range(n_slots))
        self.slot_of: dict = {}          # uid -> slot
        self.writes = 0
        self.resizes = 0

    def view(self, n: int) -> dict:
        """The cache of rows [0, n): views of the storage, no copy."""
        if not 0 < n <= self.capacity:
            raise ValueError(f"a view of {n} slots does not fit the "
                             f"arena's capacity of {self.capacity}")
        return {name: t.narrow(_SLOT_DIM[name], 0, n)
                for name, t in self.storage.items()}

    def _set_view(self, n: int):
        self.cache = self.view(n)

    @property
    def capacity(self) -> int:
        return self.storage["k"].shape[1]

    @property
    def n_slots(self) -> int:
        return self.cache["k"].shape[1]

    @property
    def n_free(self) -> int:
        return len(self.free)

    def alloc(self, uid) -> int:
        if not self.free:
            raise RuntimeError(
                f"KV arena exhausted: {len(self.slot_of)} live requests "
                f"hold all {self.n_slots} slots (admission must stay "
                f"within the decoder bucket)")
        if uid in self.slot_of:
            raise ValueError(f"request {uid} already owns slot "
                             f"{self.slot_of[uid]}")
        slot = self.free.pop(0)
        self.slot_of[uid] = slot
        return slot

    def release(self, uid) -> int:
        slot = self.slot_of.pop(uid)
        self.free.append(slot)
        self.free.sort()
        return slot

    def write(self, uid, row_cache):
        """Install a prefilled request (batch-1 cache row) in uid's slot."""
        slot = self.slot_of[uid]
        c = self.cache
        c["k"][:, slot:slot + 1] = row_cache["k"]
        c["v"][:, slot:slot + 1] = row_cache["v"]
        c["kv_pos"][slot:slot + 1] = row_cache["kv_pos"]
        c["length"][slot:slot + 1] = row_cache["length"]
        self.writes += 1
        return slot

    def rows_for(self, uids):
        return [self.slot_of[u] for u in uids]

    def grow(self, capacity: int):
        """Move the slots to new storage of `capacity` rows: slot numbers,
        the view's size and its contents stay, the rows past the old
        capacity are fresh. Every view taken before is stale after."""
        if capacity < self.capacity:
            raise ValueError(f"an arena of {self.capacity} slots does not "
                             f"grow to {capacity}")
        n = self.n_slots
        L, kv_heads, d_head = self.dims
        storage = init_full_cache(L, capacity, self.max_len, kv_heads,
                                  d_head, self.dtype, self.device)
        for name, t in self.cache.items():
            storage[name].narrow(_SLOT_DIM[name], 0, n).copy_(t)
        self.storage = storage
        self._set_view(n)

    def resize(self, new_n_slots: int, uid_order):
        """Move the live rows (in uid_order) to rows 0..k-1 of the same
        storage, through a temporary, and reset rows k..new_n_slots-1 to
        the fresh state; the view becomes rows [0, new_n_slots). Live
        requests are renumbered 0..k-1. The contents equal those of a
        fresh arena of new_n_slots slots with the live rows written in."""
        rows = [self.slot_of[u] for u in uid_order]
        k_live = len(rows)
        if k_live > new_n_slots:
            raise ValueError(f"{k_live} live requests do not fit "
                             f"{new_n_slots} slots")
        if new_n_slots > self.capacity:
            raise ValueError(f"{new_n_slots} slots exceed the arena's "
                             f"capacity of {self.capacity}")
        idx = torch.tensor(rows, dtype=torch.long, device=self.device)
        for name, t in self.storage.items():
            dim = _SLOT_DIM[name]
            if k_live:
                t.narrow(dim, 0, k_live).copy_(t.index_select(dim, idx))
            t.narrow(dim, k_live, new_n_slots - k_live).fill_(_FRESH[name])
        self._set_view(new_n_slots)
        self.slot_of = {u: i for i, u in enumerate(uid_order)}
        self.free = list(range(k_live, new_n_slots))
        self.resizes += 1
