"""Loading the reference's checkpoints: the JAX package saves reduced
smollm-135m (fp32, permuted hot-first, and at int8 / int4-mixed storage
quantized) with its own `save_checkpoint`; the port reads it with numpy
alone and serves the same greedy tokens as the reference engine on the
in-memory tree. A tree of bfloat16 leaves crosses over bit for bit, also
in a process that never loaded ml_dtypes; a missing leaf raises
KeyError and a wrong shape ValueError."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import save_checkpoint
from repro.configs import get_config as jget_config
from repro.core.planner import PHONE as JPHONE, build_plan as jbuild_plan
from repro.models import dense as jdense
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.families import _dense_prepare as jprepare
from repro_torch.bridge import load_checkpoint
from repro_torch.checkpoint.ckpt import restore_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.core.planner import PHONE, build_plan
from repro_torch.serving.engine import ServeEngine as TEngine

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference():
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = tget_config("smollm-135m").reduced()
    return jcfg, tcfg, jdense.make_model(jcfg).init(jax.random.key(3))


@pytest.mark.parametrize("sd", ["fp16", "int8", "int4-mixed"])
def test_checkpoint_serves_the_reference_tokens(reference, tmp_path, sd):
    jcfg, tcfg, params = reference
    jplan = jbuild_plan(jcfg, hw=JPHONE, storage_dtype=sd)
    params = jprepare(params, jplan)
    save_checkpoint(str(tmp_path), params, step=7)
    ckpt = restore_numpy(str(tmp_path))
    assert ckpt.step == 7
    assert ("wq" in ckpt.tree["layers"]["ffn"]) == (sd != "fp16")
    model = load_checkpoint(str(tmp_path), tcfg, device="cpu")
    assert (model.layers[0].ffn.quant is None) == (sd == "fp16")
    prompt = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    kw = dict(buckets=(2,), temperature=0.0, seed=0, backend="pallas")
    je = JEngine(jcfg, params, jplan, **kw)
    te = TEngine(tcfg, model, build_plan(tcfg, hw=PHONE, storage_dtype=sd),
                 **kw)
    jt = je.generate(prompt, max_new=5, temperature=0.0).tokens
    tt = te.generate(prompt, max_new=5, temperature=0.0).tokens
    je.close()
    te.close()
    np.testing.assert_array_equal(tt, jt)


@pytest.fixture(scope="module")
def bf16_checkpoint(reference, tmp_path_factory):
    """A bfloat16 tree, saved by the reference."""
    jcfg, _, params = reference
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    path = tmp_path_factory.mktemp("bf16")
    save_checkpoint(str(path), params)
    return path, jax.tree.map(np.asarray, params)


def _bits(t):
    return t.detach().view(torch.int16).numpy()


def test_bf16_leaves_cross_bit_for_bit(reference, bf16_checkpoint):
    _, tcfg, _ = reference
    path, tree = bf16_checkpoint
    manifest = json.loads((path / "manifest.json").read_text())
    assert {m["dtype"] for m in manifest["leaves"]} == {"bfloat16"}
    cfg = tcfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    model = load_checkpoint(str(path), cfg, device="cpu")
    lt = tree["layers"]
    assert (_bits(model.embed) == tree["embed"].view(np.int16)).all()
    for l, layer in enumerate(model.layers):
        for got, want in ((layer.attn.wq, lt["attn"]["wq"]),
                          (layer.ffn.w, lt["ffn"]["w"]),
                          (layer.ffn.pred_B, lt["ffn"]["pred"]["B"]),
                          (layer.ln1, lt["ln1"])):
            np.testing.assert_array_equal(_bits(got), want[l].view(np.int16))


def test_bf16_leaves_load_without_ml_dtypes(bf16_checkpoint):
    """np.load gives the bf16 leaves as 2-byte voids when ml_dtypes was
    never imported; the manifest's dtype carries them over by their
    bits, never by value."""
    path, tree = bf16_checkpoint
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        sys.path.insert(0, {str(ROOT / 'src')!r})
        from repro_torch.bridge import load_checkpoint
        from repro_torch.configs import get_config
        cfg = get_config("smollm-135m").reduced().replace(
            param_dtype="bfloat16", compute_dtype="bfloat16")
        assert np.load({str(path / 'embed.npy')!r}).dtype.kind == "V"
        m = load_checkpoint({str(path)!r}, cfg, device="cpu")
        assert "ml_dtypes" not in sys.modules
        import torch
        bits = m.layers[1].ffn.w.view(torch.int16).numpy()
        np.save(sys.argv[1], bits)
    """)
    out_file = path.parent / "bits.npy"
    out = subprocess.run([sys.executable, "-c", code, str(out_file)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    np.testing.assert_array_equal(
        np.load(out_file), tree["layers"]["ffn"]["w"][1].view(np.int16))


def _copy(src: Path, dst: Path):
    dst.mkdir()
    for f in src.iterdir():
        (dst / f.name).write_bytes(f.read_bytes())
    return dst


def test_missing_leaf_and_wrong_shape_raise(reference, bf16_checkpoint,
                                            tmp_path):
    _, tcfg, _ = reference
    cfg = tcfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    path, _ = bf16_checkpoint
    # a leaf the manifest lists, without its file
    p = _copy(path, tmp_path / "no_file")
    (p / "layers__attn__wk.npy").unlink()
    with pytest.raises(KeyError, match="layers__attn__wk"):
        load_checkpoint(str(p), cfg, device="cpu")
    # a leaf the model needs, missing from the checkpoint altogether
    p = _copy(path, tmp_path / "no_leaf")
    m = json.loads((p / "manifest.json").read_text())
    m["leaves"] = [e for e in m["leaves"] if e["name"] != "out_norm"]
    (p / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(KeyError, match="out_norm"):
        load_checkpoint(str(p), cfg, device="cpu")
    # a file whose shape is not the manifest's
    p = _copy(path, tmp_path / "bad_file")
    np.save(p / "out_norm.npy", np.zeros(5, np.uint16).view("V2"))
    with pytest.raises(ValueError, match="out_norm"):
        load_checkpoint(str(p), cfg, device="cpu")
    # a checkpoint of another model's shape
    p = _copy(path, tmp_path / "bad_model")
    m = json.loads((p / "manifest.json").read_text())
    for e in m["leaves"]:
        if e["name"] == "out_norm":
            e["shape"] = [5]
    (p / "manifest.json").write_text(json.dumps(m))
    np.save(p / "out_norm.npy", np.zeros(5, np.uint16).view("V2"))
    with pytest.raises(ValueError, match="out_norm: shape"):
        load_checkpoint(str(p), cfg, device="cpu")
