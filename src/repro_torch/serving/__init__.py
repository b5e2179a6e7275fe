"""Serving stack: engine, scheduler, sampler, storage plane."""
