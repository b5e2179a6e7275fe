"""The vocab-sharded embedding and head of the port over gloo ranks on
the CPU (`repro_torch.parallel.spawn`), against one rank and against
the JAX package's `jnp.take` rules.

* `embed_tokens` over 2 and 4 ranks (each rank holding V/n rows) gives
  one rank's rows bit for bit, with negative, boundary and
  out-of-range ids: a NaN row exactly where `jnp.take` gives one, once
  and not n times.
* `lm_logits` gathered over the ranks equals one rank's, the padding
  columns (vocab 300 padded to 512, spread over the last ranks) -1e30.
* A greedy tie between the last id of one rank and the first of the
  next picks the lower id.
* At a padded vocabulary that n does not divide, the embedding and head
  replicate, and no collective runs.
* The gradient through `gather_vocab` (and `copy_in` / `reduce_out`)
  equals one rank's, with no factor of n.
* A spawned training rank imports neither jax nor the JAX package.

The rank function imports only the port (the JAX package is imported
inside the fixture), so a spawned rank never loads it.
"""
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as tget_config
from repro_torch.models import dense as tdense
from repro_torch.models.model import build_model
from repro_torch.parallel import ShardGroup, replica_groups, shard_layout, \
    spawn, vocab_range
from repro_torch.serving.sampler import sample_tokens
from repro_torch.train.steps import lm_loss


def _foreign() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def _cfg():
    """Reduced smollm-135m with vocab 300, padded to 512: at 2 ranks the
    padding lies in rank 1's columns, at 4 in ranks 2 and 3's."""
    return tget_config("smollm-135m").reduced().replace(vocab_size=300)


def _ids(V):
    """Every rule of jnp.take: in range, boundaries of every rank split,
    negative ids that wrap, ids past either end."""
    edges = [0, 1, 127, 128, 255, 256, 299, 300, 383, 384, V - 1]
    return np.array([edges + [-1, -V, -129, V, V + 7, -V - 1, -3 * V]],
                    np.int32)


def _whole(cfg, untie):
    model = build_model(cfg, "cpu", seed=0).module
    if untie:
        cfg = cfg.replace(tie_embeddings=False)
        model = build_model(cfg, "cpu", seed=0).module
    return cfg, model


def _tie_token(model, g, b, D):
    """The greedy token of gathered logits whose rows b - 1 and b tie."""
    head = model.embed if model.lm_head is None else model.lm_head.T
    saved = head.clone()
    lo, hi = model.vocab
    with torch.no_grad():
        for gid in (b - 1, b):
            if lo <= gid < hi:
                head[gid - lo] = 10.0
        logits = tdense.lm_logits(model, torch.ones((1, 1, D)), g)
        tok = int(sample_tokens(logits[:, -1], 0.0)[0])
        head.copy_(saved)
    return tok


def _grads(model, g=None):
    """The loss of lookup -> logits on a few labels (one masked, one in
    the padding's neighbourhood) and its gradients of the embedding, the
    final norm and the untied head."""
    params = dict(model.named_parameters())
    labels = torch.from_numpy(np.array([[5, 260, -1, 299, 130, 0]]))
    names = ["embed", "out_norm"] + (["lm_head"] if "lm_head" in params
                                     else [])
    for k in names:
        params[k].requires_grad_(True)
    with torch.enable_grad():
        h = tdense.embed_tokens(model, labels.clamp_min(0), g)
        loss = lm_loss(tdense.lm_logits(model, h, g), labels)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
    for k in names:
        params[k].requires_grad_(False)
    return float(loss), [t.numpy() for t in grads]


def _vocab_rank(world, ids, x):
    """Every case on ranks [0, n) for n in (2, 4): embed rows, logits,
    the greedy tie and the gradients, for a tied and an untied head."""
    out = {"foreign": _foreign()}
    tid = torch.from_numpy(ids)
    tx = torch.from_numpy(x)
    for n in (2, 4):
        g = replica_groups(world, world.size // n, n)[0]
        if not g.member:
            continue
        for untie in (False, True):
            cfg = _whole(_cfg(), untie)[0]
            model = build_model(cfg, "cpu", seed=0, shard=g).module
            emb = tdense.embed_tokens(model, tid, g)
            logits = tdense.lm_logits(model, tx, g)
            # a tie across the boundary of ranks 0 and 1: head rows b - 1
            # (rank 0's last) and b (rank 1's first) set to 10 * ones, and
            # x along ones, so that the two lead every other logit
            b = cfg.vocab_padded // n
            tok = _tie_token(model, g, b, cfg.d_model)
            loss, grads = _grads(model, g)
            # the same logits through the autograd functions (x records)
            # and through the raw collectives (nothing records)
            graded = tdense.lm_logits(model, tx.clone().requires_grad_(), g)
            with torch.no_grad():
                plain = tdense.lm_logits(model, tx, g)
            paths = (torch.equal(graded.detach(), plain),
                     graded.grad_fn is not None, plain.grad_fn is None)
            out[n, untie] = dict(
                emb=emb.numpy(), logits=logits.numpy(), tie=tok,
                vocab=model.vocab, loss=loss, grads=grads, paths=paths)
    return out


@pytest.fixture(scope="module")
def vocab_runs():
    import jax.numpy as jnp
    cfg = _cfg()
    V = cfg.vocab_padded
    ids = _ids(V)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    ranks = spawn(_vocab_rank, 4, ids, x, timeout=300)
    ref = {}
    for untie in (False, True):
        whole = _whole(cfg, untie)[1]
        loss, grads = _grads(whole)
        ref[untie] = dict(
            emb=tdense.embed_tokens(whole, torch.from_numpy(ids)).numpy(),
            take=np.asarray(jnp.take(jnp.asarray(
                whole.embed.detach().numpy()), jnp.asarray(ids), axis=0)),
            logits=tdense.lm_logits(whole, torch.from_numpy(x)).numpy(),
            loss=loss, grads=grads)
    return dict(cfg=cfg, ranks=ranks, ref=ref)


def _runs(vocab_runs, n, untie):
    runs = [r[n, untie] for r in vocab_runs["ranks"] if (n, untie) in r]
    assert len(runs) == n
    return runs


@pytest.mark.parametrize("untie", [False, True], ids=["tied", "untied"])
@pytest.mark.parametrize("n", [2, 4])
def test_embed_tokens_over_ranks_matches_jnp_take(vocab_runs, n, untie):
    ref = vocab_runs["ref"][untie]
    nan = np.isnan(ref["take"]).all(axis=-1)
    assert nan.sum() == 4 and not np.isnan(ref["take"][~nan]).any()
    np.testing.assert_array_equal(ref["emb"], ref["take"])
    for r, run in enumerate(_runs(vocab_runs, n, untie)):
        V = vocab_runs["cfg"].vocab_padded
        assert run["vocab"] == (r * V // n, (r + 1) * V // n)
        np.testing.assert_array_equal(run["emb"], ref["take"])


@pytest.mark.parametrize("untie", [False, True], ids=["tied", "untied"])
@pytest.mark.parametrize("n", [2, 4])
def test_lm_logits_gathered_match_one_rank(vocab_runs, n, untie):
    cfg = vocab_runs["cfg"]
    want = vocab_runs["ref"][untie]["logits"]
    assert (want[..., cfg.vocab_size:] == np.float32(-1e30)).all()
    for run in _runs(vocab_runs, n, untie):
        got = run["logits"]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[..., cfg.vocab_size:],
                                      want[..., cfg.vocab_size:])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("untie", [False, True], ids=["tied", "untied"])
@pytest.mark.parametrize("n", [2, 4])
def test_greedy_tie_across_ranks_takes_lower_id(vocab_runs, n, untie):
    b = 256 if n == 2 else 128
    for run in _runs(vocab_runs, n, untie):
        assert run["tie"] == b - 1


@pytest.mark.parametrize("untie", [False, True], ids=["tied", "untied"])
@pytest.mark.parametrize("n", [2, 4])
def test_gather_vocab_backward_has_no_factor_of_n(vocab_runs, n, untie):
    """The loss and every gradient equal one rank's: the embedding's (and
    the head's) slices in place, the replicated norm's whole."""
    cfg = vocab_runs["cfg"]
    ref = vocab_runs["ref"][untie]
    V = cfg.vocab_padded
    for r, run in enumerate(_runs(vocab_runs, n, untie)):
        assert run["loss"] == pytest.approx(ref["loss"], rel=1e-6)
        rows = slice(r * V // n, (r + 1) * V // n)
        embed, norm = run["grads"][:2]
        tol = 1e-6 * np.abs(ref["grads"][0]).max()
        np.testing.assert_allclose(embed, ref["grads"][0][rows], atol=tol)
        np.testing.assert_allclose(norm, ref["grads"][1], rtol=1e-5,
                                   atol=1e-6 * np.abs(ref["grads"][1]).max())
        if untie:
            np.testing.assert_allclose(
                run["grads"][2], ref["grads"][2][:, rows],
                atol=1e-6 * np.abs(ref["grads"][2]).max())


@pytest.mark.parametrize("untie", [False, True], ids=["tied", "untied"])
@pytest.mark.parametrize("n", [2, 4])
def test_split_regions_skip_autograd_when_nothing_records(vocab_runs, n,
                                                          untie):
    """Under no_grad the head's copy_in and gather_vocab call the raw
    collectives (no autograd node) and give the recorded path's logits."""
    for run in _runs(vocab_runs, n, untie):
        assert run["paths"] == (True, True, True)


def test_vocab_replicates_where_ranks_do_not_divide_it():
    """vocab_padded 512 over 3 ranks: every rank holds the whole
    embedding and head, and the lookup and logits make no collective
    (the group here has no process group to make one with)."""
    cfg = _cfg().replace(tie_embeddings=False)
    assert cfg.vocab_padded % 3
    three = ShardGroup(1, 3, None, torch.device("cpu"), (0, 1, 2))
    for r in range(3):
        assert vocab_range(cfg, r, 3) == (0, cfg.vocab_padded)
        assert shard_layout(cfg, None, r, 3).vocab == (0, cfg.vocab_padded)
    assert vocab_range(cfg, 1, 4) == (128, 256)
    whole = build_model(cfg, "cpu", seed=0).module
    model = build_model(cfg, "cpu", seed=0, shard=three).module
    assert model.embed.shape == whole.embed.shape
    assert model.lm_head.shape == whole.lm_head.shape
    assert torch.equal(model.embed, whole.embed)
    ids = torch.from_numpy(_ids(cfg.vocab_padded))
    a = tdense.embed_tokens(model, ids, three)
    np.testing.assert_array_equal(a.numpy(),
                                  tdense.embed_tokens(whole, ids).numpy())
    x = torch.randn((1, 2, cfg.d_model))
    assert torch.equal(tdense.lm_logits(model, x, three),
                       tdense.lm_logits(whole, x))
    assert three.calls == 0


def test_spawned_vocab_ranks_import_no_jax(vocab_runs):
    assert all(r["foreign"] == [] for r in vocab_runs["ranks"])
