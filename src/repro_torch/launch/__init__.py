"""Launch entry points: ``serve`` (batched prefill + greedy decode) and the
flat mesh of the sharded analyze (``mesh``)."""
