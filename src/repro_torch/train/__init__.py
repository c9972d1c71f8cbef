"""Serving steps (prefill, greedy decode); training is not ported yet."""
