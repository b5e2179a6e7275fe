"""The training step: LM loss, autograd, AdamW."""
