"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches
must see 1 device; only launch/dryrun.py forces 512 placeholder devices."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def tiny_batch(cfg, B=2, S=32, seed=0, with_labels=False):
    """Family-correct input batch for a reduced config."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32) * 0.1
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32) * 0.1
    if with_labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size,
                                       (B, S)).astype(np.int32)
    return batch
