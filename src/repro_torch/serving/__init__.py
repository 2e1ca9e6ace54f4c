"""Serving: paged KV pool, continuous batching, greedy sampling, engine."""
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import ContinuousBatcher, Request

__all__ = ["ContinuousBatcher", "Engine", "EngineConfig", "Request",
           "SamplingParams"]
