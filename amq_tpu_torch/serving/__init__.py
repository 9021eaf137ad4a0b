"""Serving: the engine, continuous batching, speculative decoding and the
speed harness."""

from .engine import ContinuousBatcher, Engine, Request, kernel_linear_impl  # noqa: F401
