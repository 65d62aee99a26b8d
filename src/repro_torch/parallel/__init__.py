"""Cluster parallelism: meshes, sharding rules, the collective schedules."""
