"""Launch entry points: ``serve`` (batched prefill + greedy decode)."""
