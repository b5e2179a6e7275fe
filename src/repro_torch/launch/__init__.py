"""Entry points: build_engine and the serving CLI."""
