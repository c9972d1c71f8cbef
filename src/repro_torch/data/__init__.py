"""Deterministic synthetic data pipeline (checkpointable): the port's copy
of the JAX package's ``data``."""
from repro_torch.data.pipeline import SyntheticTextPipeline, make_batch_for

__all__ = ["SyntheticTextPipeline", "make_batch_for"]
