"""Serving (counterpart of ``cxxnet_tpu/serve/``): the bucket ladder,
the frozen engine, the dynamic batcher and the serve session, and the
fleet layer behind ``task = serve_fleet``:

- :mod:`.router` — N engines behind one front end, atomic hot-swap flip
- :mod:`.quota` — per-tenant token-bucket quotas, typed over-quota shed
- :mod:`.swap` — the verified-snapshot watcher (shadow warmup, flip,
  drain)
- :mod:`.frontend` — HTTP/JSON and the CXN1/CXN2 binary protocols over
  one shared request core
"""

from .batcher import (DynamicBatcher, ServeBusyError, ServeClosedError,
                      ServeTimeoutError)
from .bucketing import (bucket_ladder, mesh_align, pad_to_bucket,
                        parse_buckets, pick_bucket)
from .engine import InferenceEngine, StagedBatch, build_engine
from .frontend import (BinaryClient, FailoverBinaryClient,
                       FailoverHttpClient, FleetConfig, FleetServer,
                       registry_endpoints)
from .quota import QuotaManager, TenantQuotaError, TokenBucket
from .router import ModelRouter, UnknownModelError
from .server import ServeConfig, ServeSession, run_closed_loop
from .swap import SnapshotWatcher, latest_verified

__all__ = [
    "DynamicBatcher", "ServeBusyError", "ServeClosedError",
    "ServeTimeoutError", "bucket_ladder", "mesh_align", "pad_to_bucket",
    "parse_buckets", "pick_bucket", "InferenceEngine", "StagedBatch",
    "build_engine", "ServeConfig", "ServeSession", "run_closed_loop",
    "BinaryClient", "FailoverBinaryClient", "FailoverHttpClient",
    "registry_endpoints", "FleetConfig", "FleetServer", "QuotaManager",
    "TenantQuotaError", "TokenBucket", "ModelRouter",
    "UnknownModelError", "SnapshotWatcher", "latest_verified",
]
