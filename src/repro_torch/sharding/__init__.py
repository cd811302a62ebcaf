"""Sharded serving: the planner, the collectives and the shard context."""
