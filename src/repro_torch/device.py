"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else.  Raises ``RuntimeError`` when CUDA is requested
    (explicitly or by default) and absent — there is no silent CPU
    fallback; pass ``device="cpu"`` to run the plain versions on the
    host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host")
    return dev
