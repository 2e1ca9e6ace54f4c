"""Sharding rules of the multi-GPU islands (``specs``)."""
