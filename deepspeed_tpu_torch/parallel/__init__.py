"""Parallelism: the data-parallel topology and ZeRO-3 sharding."""
