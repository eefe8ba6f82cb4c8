"""Device-to-host copies that do not wait for the device."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def copy_to_host_async(*tensors: torch.Tensor
                       ) -> Tuple[List[torch.Tensor], Optional["torch.cuda.Event"]]:
    """Non-blocking copies of CUDA tensors into pinned host memory, and the
    CUDA event recorded behind them: the copies may be read once the event
    has completed (``event.query()``, or ``event.synchronize()`` to wait).
    CPU tensors are copied at once and come with no event."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.detach().clone() for t in tensors], None
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for host, t in zip(hosts, tensors):
        host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return hosts, event
