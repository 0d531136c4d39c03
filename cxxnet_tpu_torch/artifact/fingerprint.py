"""The runtime fingerprint: what a served engine's kernels and weights
were built for (the port's counterpart of ``runtime_fingerprint`` and
``fingerprint_sha`` in ``cxxnet_tpu/artifact/bundle.py``).

The reference names its JAX backend and versions; the port names its
own: backend ``torch``, the torch and CUDA versions, and the device kind
and count. A fingerprint taken under one backend never equals one taken
under the other, so an artifact cannot cross backends unnoticed.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional

import torch


def runtime_fingerprint(device: Optional[torch.device] = None
                        ) -> Dict[str, Any]:
    """Backend, versions, device kind and count of this process for
    ``device`` (the default CUDA device when None and a GPU is present,
    else the CPU). Compared by plain dict equality."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available()
                              else "cpu")
    device = torch.device(device)
    if device.type == "cuda":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        kind, count = torch.cuda.get_device_name(idx), \
            torch.cuda.device_count()
    else:
        kind, count = "cpu", 1
    return {
        "backend": "torch",
        "platform": device.type,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "device_kind": kind,
        "device_count": count,
        "process_count": 1,
    }


def fingerprint_sha(fp: Dict[str, Any]) -> str:
    """Stable short hash of a fingerprint dict (sorted-key JSON, the
    first 16 hex digits of its SHA-256), as the reference hashes its
    own."""
    blob = json.dumps(fp, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
