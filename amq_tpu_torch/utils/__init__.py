"""Utilities: span tracing and profiler capture."""
