"""Serving engine and speed harness."""
