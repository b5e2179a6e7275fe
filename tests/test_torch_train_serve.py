"""The port's checkpoint writer and the train -> plan -> serve loop
against the JAX package, on the CPU.

* `save_checkpoint` writes the reference's files byte for byte for the
  same tree (fp32, int32 and bf16 leaves, nested, and a model's
  parameters through `params_to_numpy`, in every family: the ssm's fp32
  leaves beside bf16 ones, the hybrid's group-stacked and remainder
  blocks, the encdec's two stacks), manifest included; the
  reference's `restore_checkpoint` reads the port's checkpoint, the
  port's reads the reference's; `params_to_numpy` -> `save_checkpoint`
  -> `load_checkpoint` gives back every parameter bit for bit, frozen.
* The port's counterpart of tests/test_system.py's
  test_train_plan_serve_end_to_end: from the same numpy weights both
  packages train reduced smollm-135m 15 steps (losses within 1e-5
  relative), profile the same token arrays (counts identical but for
  near-threshold pairs), plan on PHONE (neuron order and bucket plans
  identical), permute, and serve greedy through their engines: tokens
  identical, the trained models' logits within 1e-4.
* The training CLI on the CPU.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.ckpt import restore_checkpoint as jrestore
from repro.checkpoint.ckpt import save_checkpoint as jsave
from repro.core import planner as jplanner
from repro.core.baselines import POWERINFER2 as JPOWERINFER2
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models.model import build_model as jbuild_model
from repro.optim.adamw import AdamW as JAdamW
from repro.serving.engine import ServeEngine as JEngine
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.bridge import load_checkpoint, params_from_numpy, \
    params_to_numpy
from repro_torch.checkpoint.ckpt import (
    Tree, restore_checkpoint, restore_numpy, save_checkpoint)
from repro_torch.core import planner as tplanner
from repro_torch.core.baselines import POWERINFER2
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, shard_batch
from repro_torch.kernels.ref import near_threshold
from repro_torch.models import dense as tdense
from repro_torch.models.model import wrap
from repro_torch.optim.adamw import AdamW
from repro_torch.serving.engine import ServeEngine
from repro_torch.train.steps import make_train_step


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def _mixed_tree(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((2, 5, 3)).astype(np.float32)
    return {"z": {"w:1": a, "b": np.arange(6, dtype=np.int32)},
            "a": {"bf": b}, "step_t": np.float32(2.5)}


def test_save_checkpoint_bytes_match_reference(tmp_path):
    """Nested keys (sorted in the manifest as jax flattens them), a key
    that `_leaf_name` rewrites, int32, a 0-d leaf and a bf16 leaf (its
    bits under the '<V2' descr): every file byte-identical."""
    tree = _mixed_tree()
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["a"]["bf"] = jtree["a"]["bf"].astype(jnp.bfloat16)
    jsave(str(tmp_path / "ref"), jtree, step=7)
    bits = np.asarray(jtree["a"]["bf"]).view(np.uint16)
    mine = dict(tree, a={"bf": bits})
    save_checkpoint(str(tmp_path / "port"), mine, step=7,
                    dtypes={"a": {"bf": "bfloat16"}})
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(ref) == sorted(port) == [
        "a__bf.npy", "manifest.json", "step_t.npy", "z__b.npy",
        "z__w_1.npy"]
    for f in ref:
        assert port[f] == ref[f], f
    with pytest.raises(TypeError, match="declared"):
        save_checkpoint(str(tmp_path / "bad"), {"x": np.zeros(2)},
                        dtypes={"x": "float32"})


@pytest.mark.parametrize("arch,dtype", [("smollm-135m", "bfloat16"),
                                        ("deepseek-moe-16b", "float32"),
                                        ("qwen3-14b", "bfloat16"),
                                        ("mamba2-130m", "bfloat16"),
                                        ("recurrentgemma-9b", "bfloat16"),
                                        ("seamless-m4t-large-v2",
                                         "float32")])
def test_model_checkpoint_matches_reference_and_round_trips(
        tmp_path, arch, dtype):
    """A model's parameters: the port's checkpoint of params_to_numpy is
    the reference's checkpoint of the same weights byte for byte, and
    load_checkpoint gives back every parameter bit for bit, frozen."""
    def cfg_fn(c):
        return c.replace(param_dtype=dtype, compute_dtype=dtype)
    jcfg = cfg_fn(jconfigs.get_config(arch).reduced())
    tcfg = cfg_fn(tconfigs.get_config(arch).reduced())
    params = jbuild_model(jcfg).init(jax.random.key(2))
    jsave(str(tmp_path / "ref"), params, step=3)
    ck = restore_numpy(str(tmp_path / "ref"))
    model = params_from_numpy(ck.tree, tcfg, "cpu", dtypes=ck.dtypes)
    tree = params_to_numpy(model)
    assert isinstance(tree, Tree)
    save_checkpoint(str(tmp_path / "port"), tree, step=3)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    back = load_checkpoint(str(tmp_path / "port"), tcfg, "cpu")
    mine = dict(model.named_parameters())
    for name, p in back.named_parameters():
        assert p.dtype == mine[name].dtype and not p.requires_grad
        assert torch.equal(p.view(torch.int16) if p.dtype == torch.bfloat16
                           else p, mine[name].view(torch.int16)
                           if p.dtype == torch.bfloat16 else mine[name]), name


def test_restore_checkpoint_both_ways(tmp_path):
    """The reference's restore_checkpoint reads the port's fp32
    checkpoint, and the port's reads the reference's, into the structure
    of a given tree; a missing leaf and a wrong shape raise."""
    tree = {"x": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)},
            "n": np.arange(5, dtype=np.int32)}
    save_checkpoint(str(tmp_path / "port"), tree, step=11)
    got, step = jrestore(str(tmp_path / "port"), tree)
    assert step == 11
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), a)
    jsave(str(tmp_path / "ref"), jax.tree.map(jnp.asarray, tree), step=4)
    got, step = restore_checkpoint(str(tmp_path / "ref"), tree)
    assert step == 4 and got["x"]["w"].dtype == np.float32
    np.testing.assert_array_equal(got["x"]["w"], tree["x"]["w"])
    np.testing.assert_array_equal(got["n"], tree["n"])
    with pytest.raises(KeyError, match="missing leaf 'y'"):
        restore_checkpoint(str(tmp_path / "ref"), dict(tree, y=tree["n"]))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path / "ref"),
                           dict(tree, n=np.zeros(4, np.int32)))


def test_train_plan_serve_matches_reference():
    jcfg = jconfigs.get_config("smollm-135m").reduced()
    tcfg = tconfigs.get_config("smollm-135m").reduced()
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.key(0))

    # 1. fifteen steps from the same weights on the same batches
    model = wrap(params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu"))
    opt, topt = JAdamW(lr=2e-3), AdamW(lr=2e-3)
    step = jax.jit(jmake_train_step(jm, opt))
    tstep = make_train_step(model, topt)
    state, w = opt.init(params), model.params()
    tstate = topt.init(w)
    jdata = JSyntheticTokens(JDataConfig(jcfg.vocab_size, 32, 4, seed=0))
    tdata = SyntheticTokens(DataConfig(tcfg.vocab_size, 32, 4, seed=0))
    jl, tl = [], []
    for _ in range(15):
        params, state, m = step(params, state, jdata.batch())
        w, tstate, mm = tstep(w, tstate, shard_batch(tdata.batch(), "cpu"))
        jl.append(float(m["loss"]))
        tl.append(float(mm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    net = model.module
    assert not any(p.requires_grad for p in net.parameters())

    # 2. profile the trained models on the same token arrays, plan
    batches = [np.asarray(jax.random.randint(jax.random.key(i), (2, 32), 0,
                                             jcfg.vocab_size))
               for i in range(2)]
    jcounts, n_tok = jplanner.profile_activations(
        params, jcfg, [jnp.asarray(b) for b in batches])
    counts, n = tplanner.profile_activations(net, tcfg, batches)
    assert n == n_tok
    X, _ = tplanner.profile_ffn_inputs(net, tcfg, batches)
    jX, _ = jplanner.profile_ffn_inputs(params, jcfg,
                                        [jnp.asarray(b) for b in batches])
    jX = np.asarray(jX)
    jw = np.asarray(params["layers"]["ffn"]["w"])
    flags = np.stack([near_threshold(
        torch.from_numpy(jX[l]), torch.from_numpy(jw[l]), tcfg.activation,
        tcfg.sparse_ffn.mode,
        dx=float(np.abs(X[l].numpy() - jX[l]).max())).sum(0).numpy()
        for l in range(tcfg.num_layers)])
    assert (np.abs(counts - np.asarray(jcounts)) <= flags).all()
    jplan = jplanner.build_plan(
        jcfg, (np.asarray(jcounts) / n_tok).astype(np.float32),
        hw=jplanner.PHONE)
    plan = tplanner.build_plan(tcfg, (counts / n).astype(np.float32),
                               hw=tplanner.PHONE)
    np.testing.assert_array_equal(plan.neuron_order, jplan.neuron_order)
    assert {b: dataclasses.asdict(p) for b, p in plan.plans.items()} == \
        {b: dataclasses.asdict(p) for b, p in jplan.plans.items()}

    # 3. permute and serve greedy
    params = jplanner.permute_ffn_params(params, jplan.neuron_order)
    tplanner.permute_ffn_params(net, plan.neuron_order)
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want = np.asarray(jm.forward(params, {"tokens": jnp.asarray(prompt)}))
    got = tdense.forward(net, torch.from_numpy(prompt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    jeng = JEngine(jcfg, params, jplan, spec=JPOWERINFER2,
                   offload_ratio=0.5)
    eng = ServeEngine(tcfg, net, plan, spec=POWERINFER2, offload_ratio=0.5)
    jres = jeng.generate(prompt, max_new=8, temperature=0.0)
    res = eng.generate(prompt, max_new=8, temperature=0.0)
    toks = res.tokens[res.tokens >= 0]
    assert toks.size == 16 and (toks < tcfg.vocab_size).all()
    assert res.tokens.tolist() == np.asarray(jres.tokens).tolist()
    assert res.tokens_per_s > 0
    eng.close()
    jeng.close()


def test_train_cli_on_cpu(capsys):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--arch", "qwen2-vl-2b", "--steps", "3",
          "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "final loss" in out \
        and "on cpu" in out
