"""Shared parts of the benchmark harness."""
