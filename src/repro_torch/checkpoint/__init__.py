"""Reading the reference's checkpoints (numpy and json only)."""
