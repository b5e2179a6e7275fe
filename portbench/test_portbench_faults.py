"""The comparison that decides `correct`, shown to fail: the harness's
whole run on the CPU (the look for a card skipped) with the timed path
broken underneath, and the float8 control at a size a test run holds."""
import numpy as np
import pytest
import torch

from portbench.testing import run_tiny


def _alter_tokens(monkeypatch):
    """A token altered where it is produced: every third sampling, row
    0's token moves to the next id."""
    from repro_torch.serving import engine as eng
    inner, calls = eng.sample_tokens, [0]

    def sample(*a, **k):
        t = inner(*a, **k)
        calls[0] += 1
        if calls[0] % 3 == 0:
            t = t.clone()
            t[0] = (t[0] + 1) % 500
        return t
    monkeypatch.setattr(eng, "sample_tokens", sample)


def _state_unchanged(monkeypatch):
    """A decode step that leaves the KV state as it was: the new token's
    keys and values are never written."""
    from repro_torch.models import blocks
    monkeypatch.setattr(blocks, "write_kv",
                        lambda k, v, k_new, v_new, pos: (k, v))


def _half_batch(monkeypatch):
    """Half of the batch left out of the cluster picks: the union runs
    over the first half of the live rows alone."""
    from repro_torch.core import sparse_ffn
    inner = sparse_ffn.ffn_hybrid

    def hybrid(w, pred, x, *a, active_mask=None, **k):
        if active_mask is not None and int(active_mask.sum()) > 1:
            live = torch.nonzero(active_mask).reshape(-1)
            active_mask = active_mask.clone()
            active_mask[live[len(live) // 2:]] = False
        return inner(w, pred, x, *a, active_mask=active_mask, **k)
    monkeypatch.setattr(sparse_ffn, "ffn_hybrid", hybrid)


def _plane_half_cache(monkeypatch):
    """The storage plane priced with half its neuron cache."""
    from repro_torch.serving import storage_plane as sp
    inner = sp.NeuronCache

    class Half(inner):
        def __init__(self, *a, capacity_neurons, **k):
            super().__init__(*a, capacity_neurons=capacity_neurons // 2, **k)
    monkeypatch.setattr(sp, "NeuronCache", Half)


@pytest.mark.parametrize("fault, number", [
    (_alter_tokens, "logit_gap"),
    (_state_unchanged, "logit_gap"),
    (_half_batch, "pick_gap"),
    (_plane_half_cache, "stats_off"),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault,
                                            number):
    fault(monkeypatch)
    out, lines = run_tiny(tmp_path, seed=3)
    assert not out["correct"], lines
    c = out["checks"][number]
    assert c["value"] > c["limit"], lines


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_reads_far_above_the_program(tmp_path, seed):
    """At bf16, under the tiny cell's limits (set as a cell's are, from
    its readings: `testing.TINY_BF16_LIMITS`), the program comes out
    correct and the float8 control, judged as `control.py` judges it
    (`judge.decide_control`), not correct; its logit gap lies at least
    three times above the program's."""
    from portbench.testing import TINY_BF16_LIMITS
    out, lines = run_tiny(tmp_path, seed=seed, dtype="bfloat16",
                          limits=TINY_BF16_LIMITS, control=True)
    assert out["correct"], lines
    assert not out["control"]["correct"], lines
    prog = out["checks"]["logit_gap"]["value"]
    ctl = out["control"]["checks"]["logit_gap"]["value"]
    assert ctl > TINY_BF16_LIMITS["logit_gap"] and ctl >= 3 * prog, lines
    assert np.isfinite(out["control"]["checks"]["pick_gap"]["value"])
