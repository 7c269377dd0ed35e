"""Device choice for the port.

Every entry point takes an explicit `device`.  `cuda()` is the default
for a run on the card and raises when no GPU is present; the CPU is only
used when a caller passes device="cpu" (the tests do).
"""

from __future__ import annotations

import functools
import shutil
import subprocess

import torch


def cuda(index: int = 0) -> torch.device:
    """The CUDA device `index`; raises RuntimeError without a GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("halo_tpu_torch: no CUDA device is available")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"halo_tpu_torch: no CUDA device {index}")
    return torch.device("cuda", index)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    for the first card (name and power limit, as the tool prints them)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sync_stream(dev: torch.device) -> None:
    """Wait for the calling thread's current stream on `dev` only: a
    thread of parallel/pipeline.py must not wait for the other's work."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def cached(maxsize: int):
    """functools.lru_cache for a function that builds device tensors (a
    tensor, or a tuple of tensors and None).  On a miss the building
    thread's stream is synchronised before the value is cached, so a
    thread on another stream (parallel/pipeline.py) never reads a cached
    tensor whose copy or kernel has not finished."""
    def wrap(fn):
        @functools.wraps(fn)
        def build(*args, **kwargs):
            out = fn(*args, **kwargs)
            for t in out if isinstance(out, tuple) else (out,):
                if isinstance(t, torch.Tensor):
                    sync_stream(t.device)
            return out
        return functools.lru_cache(maxsize)(build)
    return wrap
