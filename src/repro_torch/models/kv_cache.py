"""Decode-time KV cache and the slot arena for continuous batching.

Counterpart of `repro/models/kv_cache.py`. The cache is a dict of
tensors: k/v (L, B, T, KV, dh), kv_pos (B, T) absolute position of each
slot (-1 = empty) and length (B,). Unlike the reference's immutable
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


def write_kv(k_layer, v_layer, k_new, v_new, pos):
    """Insert one token per batch row at slot pos % T, in place.
    k_layer (B, T, KV, dh); k_new (B, 1, KV, dh); pos (B,)."""
    T = k_layer.shape[1]
    rows = torch.arange(k_layer.shape[0], device=k_layer.device)
    slot = (pos % T).long()
    k_layer[rows, slot] = k_new[:, 0]
    v_layer[rows, slot] = v_new[:, 0]
    return k_layer, v_layer


def write_pos(kv_pos, pos):
    """Record the absolute position `pos` (B,) at slot pos % T, in place."""
    T = kv_pos.shape[1]
    rows = torch.arange(kv_pos.shape[0], device=kv_pos.device)
    kv_pos[rows, (pos % T).long()] = pos.to(kv_pos.dtype)
    return kv_pos


class KVSlotArena:
    """Fixed-slot KV arena with a free list (continuous batching).

    Physical layout is the ordinary full cache — (L, n_slots, T, KV, dh)
    buffers — but rows are *slots* owned by live requests. Admitting a
    request writes its prefilled KV into a free slot (live rows
    untouched); completion returns the slot to the free list. Freed slots
    keep decoding as masked "zombie" lanes whose outputs are ignored, so
    the decode shape never changes inside a bucket. `resize`, the only
    operation that reshapes the buffers, runs only at decoder
    bucket-boundary crossings.
    """

    def __init__(self, n_layers, n_slots, max_len, kv_heads, d_head, dtype,
                 device):
        self.dims = (n_layers, kv_heads, d_head)
        self.max_len = max_len
        self.dtype = dtype
        self.device = device
        self.cache = init_full_cache(n_layers, n_slots, max_len, kv_heads,
                                     d_head, dtype, device)
        self.free = list(range(n_slots))
        self.slot_of: dict = {}          # uid -> slot
        self.writes = 0
        self.resizes = 0

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

    def resize(self, new_n_slots: int, uid_order):
        """Gather live rows (in uid_order) into a new arena of
        `new_n_slots` slots; live requests are renumbered 0..k-1."""
        rows = [self.slot_of[u] for u in uid_order]
        k_live = len(rows)
        if k_live > new_n_slots:
            raise ValueError(f"{k_live} live requests do not fit "
                             f"{new_n_slots} slots")
        nl, kv, dh = self.dims
        new = init_full_cache(nl, new_n_slots, self.max_len, kv, dh,
                              self.dtype, self.device)
        if k_live:
            idx = torch.tensor(rows, dtype=torch.long, device=self.device)
            new["k"][:, :k_live] = self.cache["k"].index_select(1, idx)
            new["v"][:, :k_live] = self.cache["v"].index_select(1, idx)
            new["kv_pos"][:k_live] = self.cache["kv_pos"].index_select(0, idx)
            new["length"][:k_live] = self.cache["length"].index_select(0, idx)
        self.cache = new
        self.slot_of = {u: i for i, u in enumerate(uid_order)}
        self.free = list(range(k_live, new_n_slots))
        self.resizes += 1
