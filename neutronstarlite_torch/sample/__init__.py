"""Sampling for the mini-batch trainer: host sampler, worker pool, pipeline, device and fused draws."""
