"""Port hygiene: the port and chip_smoke.py import no jax and nothing of
the JAX package; entry points refuse a missing card instead of running
on the CPU; the pieces the parity tests do not reach (zombie KV lanes,
fp16-only storage accounting, the CLI) behave as documented."""
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
        for n in names:
            importlib.import_module(n)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(ROOT / 'chip_smoke.py')!r})
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


def test_entry_points_refuse_a_missing_card(monkeypatch):
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.dense import make_model
    from repro_torch.configs import get_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine()
    with pytest.raises(RuntimeError, match="cuda"):
        make_model(get_config("smollm-135m").reduced())


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
    from repro.quant.quantize import bundle_nbytes as jbytes
    from repro_torch.core.clusters import make_plan
    from repro_torch.core.planner import ExecutionPlan, PHONE
    from repro_torch.quant.quantize import bundle_nbytes
    from repro_torch.quant.storage import plan_storage_dtype
    assert bundle_nbytes(576, "fp16") == jbytes(576, "fp16") == 3456
    for sd in ("int8", "int4-mixed"):
        with pytest.raises(NotImplementedError, match="quantized-storage"):
            bundle_nbytes(576, sd)
    plan = ExecutionPlan("x", 512, 32, np.zeros((1, 512), np.int32),
                         np.zeros((1, 512), np.float32),
                         {1: make_plan(512, 0.25, 0.2, 32,
                                       storage_dtype="int8")}, PHONE)
    with pytest.raises(NotImplementedError, match="quantized-storage"):
        plan_storage_dtype(plan)


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--reduced", "--device", "cpu", "--backend", "pallas", "--bon",
          "2", "--max-new", "3", "--temperature", "0"])
    out = capsys.readouterr().out
    assert "modeled decode" in out and "6 tokens on cpu" in out


def test_sampler_greedy_and_seeded():
    from repro_torch.serving.sampler import sample_tokens
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0], [5.0, 0.0, 1.0, 0.0]])
    assert sample_tokens(logits, 0.0).tolist() == [1, 0]   # first maximum
    draw = lambda: sample_tokens(logits, 1.0, top_k=2,
                                 generator=torch.Generator().manual_seed(3))
    a, b = draw(), draw()
    assert a.tolist() == b.tolist() and a.dtype == torch.int32
    assert a[0].item() in (1, 2) and a[1].item() in (0, 2)
