"""Data pipeline: the seeded synthetic token corpus."""
