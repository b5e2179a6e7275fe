"""Dense-family model: modules, attention, KV cache, blocks."""
