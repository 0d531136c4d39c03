"""Serving: bucketed inference engine, dynamic batcher, serve session."""

from .batcher import (DynamicBatcher, ServeBusyError, ServeClosedError,
                      ServeTimeoutError)
from .engine import InferenceEngine, build_engine
from .server import ServeConfig, ServeSession, run_closed_loop

__all__ = ["DynamicBatcher", "ServeBusyError", "ServeClosedError",
           "ServeTimeoutError", "InferenceEngine", "build_engine",
           "ServeConfig", "ServeSession", "run_closed_loop"]
