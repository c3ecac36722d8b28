"""Parallel execution helpers of the port (activation-sharding context)."""
