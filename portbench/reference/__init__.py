"""The plain reference (numpy and the standard library only)."""
