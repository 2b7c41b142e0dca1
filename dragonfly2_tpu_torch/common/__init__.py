"""Shared helpers: errors, units, piece math, metrics, digests, shards."""
