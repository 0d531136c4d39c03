"""Device choice for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. When no
device is asked for and no GPU is found they raise; they never carry on
on the CPU in its place.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA request without a usable GPU
    raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cxxnet_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # float32 serving means float32: cuDNN convolutions default to
        # TF32 (about three decimal digits), which would make the f32
        # path disagree with the reference's f32 path. Both switches
        # are process-wide.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError("cxxnet_tpu_torch runs on cuda or cpu, not %r"
                         % str(dev))
    return dev
