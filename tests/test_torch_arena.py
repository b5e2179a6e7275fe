"""Buffers that never move, for the decode step's CUDA graphs: the KV
slot arena resizes in place (its storage pointers stay, its contents
equal a fresh arena's row for row) and moves only when it grows,
decode_step updates every cache
tensor in place and decodes the same on the arena's views as on a plain
cache, and the decoder's pieces (prewarm, switches, BatchTracker) match
the reference's. Reduced smollm-135m, fp32, on the CPU."""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import adaptation as jad
from repro.core.planner import PHONE as JPHONE, build_plan as jbuild_plan
from repro_torch.configs import get_config
from repro_torch.core import adaptation as tad
from repro_torch.core.planner import PHONE, build_plan
from repro_torch.models import dense
from repro_torch.models.kv_cache import KVSlotArena, init_full_cache
from repro_torch.serving.engine import ServeEngine

# (L, KV heads, d_head, T) of the arena tests
DIMS = (2, 3, 4, 6)


def _arena(n, capacity):
    L, KV, dh, T = DIMS
    return KVSlotArena(L, n, T, KV, dh, torch.float32, "cpu",
                       capacity=capacity)


def _row(seed):
    """A prefilled batch-1 cache row of random contents."""
    L, KV, dh, T = DIMS
    g = torch.Generator().manual_seed(seed)
    row = init_full_cache(L, 1, T, KV, dh, torch.float32, "cpu")
    row["k"].normal_(generator=g)
    row["v"].normal_(generator=g)
    n = 2 + seed % 3
    row["kv_pos"][0, :n] = torch.arange(n, dtype=torch.int32)
    row["length"].fill_(n)
    return row


def _fresh_like(n, rows):
    """What the arena must hold after resizing to n slots: a fresh cache
    with the live rows (in order) written in."""
    L, KV, dh, T = DIMS
    c = init_full_cache(L, n, T, KV, dh, torch.float32, "cpu")
    for name, dim in (("k", 1), ("v", 1), ("kv_pos", 0), ("length", 0)):
        if rows:
            c[name].narrow(dim, 0, len(rows)).copy_(torch.cat(
                [r[name] for r in rows], dim=dim))
    return c


def _ptrs(arena):
    return {k: t.data_ptr() for k, t in arena.storage.items()}


def test_arena_resizes_in_place_and_equals_a_fresh_arena():
    arena = _arena(2, capacity=8)
    ptrs = _ptrs(arena)
    rows = {}
    for uid in (10, 11):
        arena.alloc(uid)
        rows[uid] = _row(uid)
        arena.write(uid, rows[uid])
    # a zombie lane's garbage must not survive a resize
    arena.release(10)
    arena.cache["k"][:, 0] = 7.0
    order = [11]
    # up, down, back up to a bucket already visited, down again
    for n, admit in ((4, [12, 13, 14]), (2, []), (8, [15, 16]), (4, [])):
        arena.resize(n, order)
        assert _ptrs(arena) == ptrs
        expect = _fresh_like(n, [rows[u] for u in order])
        assert arena.n_slots == n
        for name in expect:
            assert torch.equal(arena.cache[name], expect[name]), (n, name)
            assert arena.cache[name].data_ptr() == ptrs[name]
        assert arena.free == list(range(len(order), n))
        for uid in admit:
            arena.alloc(uid)
            rows[uid] = _row(uid)
            arena.write(uid, rows[uid])
            order.append(uid)
        # keep at most the next bucket's worth of live requests
        while len(order) > 2:
            arena.release(order.pop(0))
    for l in range(DIMS[0]):
        assert arena.cache["k"][l].is_contiguous()
    with pytest.raises(ValueError, match="capacity"):
        arena.resize(9, order)
    with pytest.raises(ValueError, match="do not fit"):
        arena.resize(1, order)


def test_arena_grow_keeps_slots_and_contents():
    """`grow` moves the slots to larger storage with their numbers and
    contents; the new rows are fresh, and a resize after it equals a
    fresh arena as before. It never shrinks."""
    arena = _arena(2, capacity=2)
    ptrs = _ptrs(arena)
    rows = {}
    for uid in (20, 21):
        arena.alloc(uid)
        rows[uid] = _row(uid)
        arena.write(uid, rows[uid])
    arena.release(20)
    before = {k: v.clone() for k, v in arena.cache.items()}
    arena.grow(8)
    assert arena.capacity == 8 and arena.n_slots == 2
    assert all(_ptrs(arena)[k] != ptrs[k] for k in ptrs)
    assert arena.slot_of == {21: 1} and arena.free == [0]
    for name, t in before.items():
        assert torch.equal(arena.cache[name], t)
    fresh = init_full_cache(DIMS[0], 8, DIMS[3], DIMS[1], DIMS[2],
                            torch.float32, "cpu")
    for name, dim in (("k", 1), ("v", 1), ("kv_pos", 0), ("length", 0)):
        assert torch.equal(arena.storage[name].narrow(dim, 2, 6),
                           fresh[name].narrow(dim, 2, 6))
    arena.resize(5, [21])
    for name, t in _fresh_like(5, [rows[21]]).items():
        assert torch.equal(arena.cache[name], t)
    with pytest.raises(ValueError, match="does not grow"):
        arena.grow(4)
    with pytest.raises(ValueError, match="capacity"):
        arena.view(9)


def test_launch_counts_cover_every_counted_wrapper():
    """ops owns the registry of counted kernel wrappers that a graph
    replay keeps true: every wrapper with a `launches` count is in it,
    and setting the counts sets each wrapper's."""
    from repro_torch.kernels import ops
    counted = {n for n in ops.__all__
               if hasattr(getattr(ops, n), "launches")}
    saved = ops.launch_counts()
    assert set(saved) == counted == {"fused_cold_ffn", "cluster_gather_ffn",
                                     "dense_ffn"}
    try:
        ops.set_launch_counts({n: i + 5 for i, n in enumerate(sorted(saved))})
        assert [getattr(ops, n).launches for n in sorted(saved)] == [5, 6, 7]
    finally:
        ops.set_launch_counts(saved)
    assert ops.launch_counts() == saved


@pytest.fixture(scope="module")
def reduced():
    cfg = get_config("smollm-135m").reduced()
    model = dense.make_model(cfg, device="cpu", seed=0)
    return cfg, model, build_plan(cfg, hw=PHONE, backend="pallas")


def test_decode_step_keeps_every_cache_tensor_in_place(reduced):
    """Decoding on an arena's views writes in place (every data_ptr
    stays) and gives the same logits, trace and cache as decoding on an
    ordinary contiguous cache."""
    cfg, model, plan = reduced
    p = plan.plan_for_batch(4)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 6)).astype(
        np.int32))
    _, cache = dense.prefill(model, prompt, max_len=12)
    arena = KVSlotArena(cfg.num_layers, 4, 12, cfg.num_kv_heads,
                        cfg.d_head, torch.float32, "cpu", capacity=8)
    for j in range(3):
        arena.alloc(j)
        arena.write(j, {k: (v[:, j:j + 1] if k in ("k", "v")
                            else v[j:j + 1]) for k, v in cache.items()})
    plain = {k: v.clone().contiguous() for k, v in arena.cache.items()}
    ptrs = {k: v.data_ptr() for k, v in arena.cache.items()}
    mask = torch.tensor([True, True, True, False])
    step = dense.make_decode_step(cfg, collect_indices=True)
    for _ in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1)).astype(
            np.int32))
        la, ca, ia = step(model, tok, arena.cache, p, mask)
        lp, cp, ip = step(model, tok, plain, p, mask)
        assert ca is arena.cache and cp is plain
        assert {k: v.data_ptr() for k, v in ca.items()} == ptrs
        assert torch.equal(la, lp) and torch.equal(ia, ip)
        for k in plain:
            assert torch.equal(ca[k], plain[k])
    assert arena.cache["length"].tolist() == [9, 9, 9, 3]


def test_decoder_prewarm_and_switches_match_reference():
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = get_config("smollm-135m").reduced()
    buckets = (1, 2, 4, 8)
    jd = jad.BucketedDecoder(jbuild_plan(jcfg, hw=JPHONE),
                             lambda p: (lambda *a: a), buckets=buckets,
                             backend="pallas")
    td = tad.BucketedDecoder(build_plan(tcfg, hw=PHONE),
                             lambda p: (lambda *a: a), buckets=buckets,
                             backend="pallas")
    for d in (jd, td):
        d.prewarm()
    assert td.switches == jd.switches == len(buckets)
    assert td.live_plans().keys() == jd.live_plans().keys()
    for b, p in td.live_plans().items():
        jp = jd.live_plans()[b]
        assert (p.n_hot, p.clusters_per_group, p.backend) == \
            (jp.n_hot, jp.clusters_per_group, jp.backend)
    for batch in (3, 3, 1, 8, 7, 2, 9):
        assert td.executable_for(batch)[0].n_hot == \
            jd.executable_for(batch)[0].n_hot
        assert td.switches == jd.switches
    assert tad.bucket_for(9, buckets) == jad.bucket_for(9, buckets) == 8


def test_batch_tracker_matches_reference():
    jt, tt = jad.BatchTracker(), tad.BatchTracker()
    for op, n in (("start", 4), ("finish", 1), ("start", 2), ("finish", 9),
                  ("start", 1), ("finish", 1)):
        getattr(jt, op)(n)
        getattr(tt, op)(n)
    assert tt.history == jt.history and tt.active == jt.active == 0


def test_cuda_graphs_switch_on_the_cpu(reduced):
    cfg, model, _ = reduced
    plan = build_plan(cfg, hw=PHONE)
    with pytest.raises(ValueError, match="cuda_graphs=True needs a CUDA"):
        ServeEngine(cfg, model, plan, cuda_graphs=True)
    for flag in (None, False):
        e = ServeEngine(cfg, model, plan, cuda_graphs=flag, buckets=(1, 2))
        assert e.cuda_graphs is False and e.decoder.graphs is False
        _, fn = e.decoder.executable_for(1)
        assert not isinstance(fn, tad.GraphedStep)
        e.close()
    # a graphed table has nothing to capture on before the engine's
    # buffers are bound, and a graph needs CUDA buffers
    d = tad.BucketedDecoder(plan, lambda p: (lambda *a: a), buckets=(1,),
                            graphs=True)
    with pytest.raises(RuntimeError, match="none are bound"):
        d.prewarm()
    _, fn = d.executable_for(1)
    with pytest.raises(ValueError, match="CUDA buffers"):
        fn(model, torch.zeros((1, 1), dtype=torch.int32), {},
           torch.ones(1, dtype=torch.bool))
