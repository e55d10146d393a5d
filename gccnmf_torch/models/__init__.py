"""Workload pipelines: offline separation."""
