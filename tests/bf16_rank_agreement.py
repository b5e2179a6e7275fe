"""bf16 greedy-token agreement over 4 ranks, reference against port.

A standalone measurement, not a test (pytest collects test_*.py only):

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/bf16_rank_agreement.py

For the reduced configs of mamba2-130m, recurrentgemma-9b and
seamless-m4t-large-v2 in bf16 (params and compute), on the reference's
init from jax key 0 (perturbed as tests/test_torch_families.py does) cast
to bf16: B 4 prompts of 32 tokens (conftest.tiny_batch, seed 1), then 24
greedy decode steps without a plan.

* the reference: one device, and a tp=4 serving mesh of 4 host devices
  (XLA_FLAGS set before jax is imported, in a subprocess; params placed
  by launch/input_specs.param_specs), the fraction of the 96 tokens that
  agree;
* the port: one rank, and 4 gloo ranks (parallel.spawn) on the same
  weights through bridge.params_from_numpy, the same fraction; beside
  it, the port's one rank against the reference's one device.

Prints one line per family and exits 0.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np

ARCHS = ["mamba2-130m", "recurrentgemma-9b", "seamless-m4t-large-v2"]
B, S, N_DEC = 4, 32, 24
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

_REFERENCE = textwrap.dedent("""
    import os, sys, dataclasses, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    sys.path[:0] = [%(src)r, %(tests)r]
    from repro.configs import get_config
    from repro.models.model import build_model
    from repro.compat import set_mesh
    from repro.launch.mesh import make_serving_mesh
    from repro.launch.input_specs import param_specs
    from test_torch_families import _perturbed
    from conftest import tiny_batch
    ARCHS, B, S, N_DEC = %(archs)r, %(B)d, %(S)d, %(N)d

    def decode(m, params, batch):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        prefill = jax.jit(lambda p, b: m.prefill(p, b, max_len=S + N_DEC))
        step = jax.jit(lambda p, t, c: m.decode_step(p, t, c, None))
        logits, cache = prefill(params, jb)
        toks = []
        for _ in range(N_DEC):
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(tok)[:, 0])
            logits, cache = step(params, tok, cache)[:2]
        return np.stack(toks)

    out = {}
    for arch in ARCHS:
        c32 = get_config(arch).reduced()
        cfg = dataclasses.replace(c32, param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
        tree32 = _perturbed(build_model(c32).init(jax.random.key(0)))
        m = build_model(cfg)
        shapes = jax.eval_shape(m.init, jax.random.key(0))
        params = jax.tree.map(lambda a, s: jnp.asarray(a).astype(s.dtype),
                              tree32, shapes)
        batch = tiny_batch(c32, B, S, seed=1)
        t1 = decode(m, params, batch)
        mesh = make_serving_mesh(4)
        with set_mesh(mesh):
            specs = param_specs(m, cfg, mesh)
            ps = jax.tree.map(lambda a, s: jax.device_put(a, s.sharding),
                              params, specs)
            t4 = decode(m, ps, batch)
        out[arch] = dict(
            tree=jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                              params), batch=batch, t1=t1, t4=t4)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


def _cfg(arch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def _decode(m, batch):
    import torch
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, cache = m.prefill(m.module, tb, S + N_DEC)
        toks = []
        for _ in range(N_DEC):
            tok = logits[:, -1].float().argmax(-1).to(torch.int32)[:, None]
            toks.append(tok[:, 0].numpy())
            logits, cache = m.decode_step(m.module, tok, cache, None)[:2]
    return np.stack(toks)


def _port_rank(world, ref):
    """One gloo rank: every family at tp=4 and, on rank 0, one rank."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.model import wrap
    out = {}
    for arch in ARCHS:
        r = ref[arch]
        m = wrap(params_from_numpy(r["tree"], _cfg(arch), "cpu",
                                   shard=world), world)
        out[arch, 4] = _decode(m, r["batch"])
        if world.rank == 0:
            out[arch, 1] = _decode(wrap(params_from_numpy(
                r["tree"], _cfg(arch), "cpu")), r["batch"])
    return out


def main():
    from repro_torch.parallel import spawn
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.pkl")
        prog = _REFERENCE % dict(src=SRC, tests=HERE, archs=ARCHS, B=B, S=S,
                                 N=N_DEC)
        subprocess.run([sys.executable, "-c", prog, path], check=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
        with open(path, "rb") as f:
            ref = pickle.load(f)
    ranks = spawn(_port_rank, 4, ref, timeout=900)
    for arch in ARCHS:
        t1, t4 = ranks[0][arch, 1], ranks[0][arch, 4]
        assert all(np.array_equal(r[arch, 4], t4) for r in ranks)
        print(f"{arch}: bf16 tokens agreeing, tp=4 against one: reference "
              f"{np.mean(ref[arch]['t1'] == ref[arch]['t4']):.4f}, port "
              f"{np.mean(t1 == t4):.4f} ({t1.size} tokens); port one rank "
              f"against reference one device "
              f"{np.mean(t1 == ref[arch]['t1']):.4f}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.exit(main())
