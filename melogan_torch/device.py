"""Device selection: the port runs on the GPU unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Dict, Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a torch.device with an explicit index. Asking for CUDA on
    a machine without a card raises: the port never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def device_info(device: torch.device) -> Dict[str, object]:
    """Platform summary for /healthz and results: {"platform", "kind", "count"}."""
    if device.type == "cuda":
        return {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
        }
    return {"platform": "cpu", "kind": "cpu", "count": 1}
