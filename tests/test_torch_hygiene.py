"""Port hygiene: the port (its analysis gate and that gate's CLI too), its
examples (examples_torch/) and chip_smoke.py import no jax and nothing of
the JAX package; entry points refuse a missing card instead of running
on the CPU; the pieces the parity tests do not reach (zombie KV lanes,
storage accounting, the CLI at every storage dtype, where the quantized
containers live) behave as documented."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def test_port_and_smoke_import_no_jax():
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        sys.path.insert(0, {str(ROOT / 'src')!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        assert "repro_torch.checkpoint.ckpt" in names
        assert {{"repro_torch.serving.gateway", "repro_torch.models.vlm",
                 "repro_torch.configs.paper_models",
                 "repro_torch.configs.qwen3_14b",
                 "repro_torch.configs.qwen2_vl_2b",
                 "repro_torch.models.moe", "repro_torch.parallel",
                 "repro_torch.optim.adamw", "repro_torch.train.steps",
                 "repro_torch.launch.train",
                 "repro_torch.models.model", "repro_torch.models.ssm",
                 "repro_torch.models.rglru",
                 "repro_torch.models.encdec",
                 "repro_torch.kernels.registry",
                 "repro_torch.analysis", "repro_torch.analysis.__main__",
                 "repro_torch.analysis.framework",
                 "repro_torch.analysis.dispatch_rules",
                 "repro_torch.analysis.sanitizer"}} <= set(names)
        for n in names:
            importlib.import_module(n)
        paths = [{str(ROOT / 'chip_smoke.py')!r}] + sorted(
            str(p) for p in __import__("pathlib").Path(
                {str(ROOT / 'examples_torch')!r}).glob("*.py"))
        assert len(paths) == 5, paths
        for path in paths:
            spec = importlib.util.spec_from_file_location("m", path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25     # every module was imported


def test_analysis_cli_imports_no_jax():
    """`python -m repro_torch.analysis --self-test` (the package's
    __main__ over the static fixtures) loads no module of jax or the JAX
    package; the test above imports every module of the gate."""
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.path.insert(0, {str(ROOT / 'src')!r})
        sys.argv = ["repro_torch.analysis", "--self-test"]
        try:
            runpy.run_module("repro_torch.analysis", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert "repro_torch.analysis.kernel_hygiene" in sys.modules
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def _rank_modules(shard):
    """A spawned rank's own report: its rank and the modules of jax or
    the JAX package it has loaded, after importing every port module."""
    import importlib
    import pkgutil
    import repro_torch
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(m.name)
    return shard.rank, sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib",
                                                     "repro"))


def test_spawned_rank_imports_no_jax():
    from repro_torch.parallel import spawn
    assert spawn(_rank_modules, 2, timeout=120) == [(0, []), (1, [])]


def test_every_cuda_source_is_built_and_bound():
    """Each csrc/*.cu is in build.SOURCES with a ctypes signature whose
    pointer/int sequence matches its extern "C" launch function, and the
    wrappers never reach nvcc for CPU tensors."""
    import re
    from repro_torch.kernels import build
    srcs = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sorted(build.SOURCES) == srcs == sorted(build._ARGTYPES)
    for name in srcs:
        text = (build.CSRC / f"{name}.cu").read_text()
        sig = re.search(rf"int {name}_launch\(([^)]*)\)", text).group(1)
        kinds = [build._P if ("*" in a) else build._I
                 for a in sig.split(",")]
        assert kinds == build._ARGTYPES[name], name
        assert f"const char* {name}_error_string(int code)" in text
        assert "Replaces the Pallas TPU kernel" in text


def test_entry_points_refuse_a_missing_card(monkeypatch):
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.dense import make_model
    from repro_torch.configs import get_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine()
    with pytest.raises(RuntimeError, match="cuda"):
        make_model(get_config("smollm-135m").reduced())


def test_train_refuses_a_missing_card(monkeypatch):
    """Training runs on the card unless the caller asks for the CPU."""
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model
    from repro_torch.configs import get_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train("smollm-135m", steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_config("smollm-135m").reduced())


def test_zombie_lane_writes_wrap_the_ring():
    """A freed slot keeps decoding past the arena length: its writes go
    to pos % T instead of raising."""
    from repro_torch.models.kv_cache import init_full_cache, write_kv, \
        write_pos
    c = init_full_cache(1, 2, 4, 1, 2, torch.float32, "cpu")
    pos = torch.tensor([1, 6], dtype=torch.int32)
    write_pos(c["kv_pos"], pos)
    new = torch.ones((2, 1, 1, 2))
    write_kv(c["k"][0], c["v"][0], new, new * 2, pos)
    assert c["kv_pos"].tolist() == [[-1, 1, -1, -1], [-1, -1, 6, -1]]
    assert c["k"][0, 1, 2].tolist() == [[1.0, 1.0]]
    assert c["v"][0, 0, 1].tolist() == [[2.0, 2.0]]


def test_storage_accounting_is_fp16_only():
    """fp16 is the one storage dtype priced unpadded (rows * d * itemsize,
    the legacy accounting); int8 and int4-mixed are padded to the 4 KiB
    read block, as the reference prices them, and no longer raise."""
    from repro.quant.quantize import bundle_nbytes as jbytes
    from repro_torch.core.clusters import make_plan
    from repro_torch.core.planner import ExecutionPlan, PHONE
    from repro_torch.quant.quantize import BUNDLE_ALIGN, bundle_nbytes
    from repro_torch.quant.storage import plan_storage_dtype
    assert bundle_nbytes(576, "fp16") == jbytes(576, "fp16") == 3456
    for sd in ("int8", "int4-mixed"):
        assert bundle_nbytes(576, sd) == jbytes(576, sd) == BUNDLE_ALIGN
        assert bundle_nbytes(576, sd, align=0) == jbytes(576, sd, align=0)
    plan = ExecutionPlan("x", 512, 32, np.zeros((1, 512), np.int32),
                         np.zeros((1, 512), np.float32),
                         {1: make_plan(512, 0.25, 0.2, 32,
                                       storage_dtype="int8")}, PHONE)
    assert plan_storage_dtype(plan) == "int8"
    plan.plans[2] = make_plan(512, 0.25, 0.2, 32)
    with pytest.raises(ValueError, match="disagree"):
        plan_storage_dtype(plan)


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--reduced", "--device", "cpu", "--backend", "pallas", "--bon",
          "2", "--max-new", "3", "--temperature", "0"])
    out = capsys.readouterr().out
    assert "modeled decode" in out and "6 tokens on cpu" in out


@pytest.mark.parametrize("sd", ["int8", "int4-mixed"])
def test_serve_cli_quantized_on_cpu(capsys, sd):
    from repro_torch.launch.serve import main
    main(["--reduced", "--device", "cpu", "--backend", "pallas",
          "--storage-dtype", sd, "--temperature", "0", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"storage_dtype={sd}" in out and "4 tokens on cpu" in out


def test_quantized_model_keeps_codes_on_the_ffn():
    """The quantized containers live on each layer's FFN module, beside
    attention's own wq, and move with the model."""
    from repro_torch.launch.serve import build_engine
    engine, cfg = build_engine(device="cpu", storage_dtype="int4-mixed")
    layer = engine.model.layers[0]
    wq, wsc, wout = layer.ffn.quant
    N, R, D = layer.ffn.w.shape
    assert (wq.dtype, wsc.dtype, wout.dtype) == (torch.int8, torch.float32,
                                                 torch.float16)
    assert wq.shape == wout.shape == (N, R, D) and wsc.shape == (N, R)
    assert layer.attn.wq.dtype == torch.float32
    assert {"ffn.wq", "ffn.wsc", "ffn.wout"} <= {
        n.split("layers.0.")[-1] for n, _ in engine.model.named_buffers()}
    engine.close()


def test_sampler_greedy_and_seeded():
    from repro_torch.serving.sampler import sample_tokens
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0], [5.0, 0.0, 1.0, 0.0]])
    assert sample_tokens(logits, 0.0).tolist() == [1, 0]   # first maximum
    draw = lambda: sample_tokens(logits, 1.0, top_k=2,
                                 generator=torch.Generator().manual_seed(3))
    a, b = draw(), draw()
    assert a.tolist() == b.tolist() and a.dtype == torch.int32
    assert a[0].item() in (1, 2) and a[1].item() in (0, 2)
