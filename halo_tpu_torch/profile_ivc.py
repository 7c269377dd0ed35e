"""Where an IVC step's time goes on the card: wall time, device busy time
and the device's idle share of one warm step, with the kernels that take
the device time.

    python3 -m halo_tpu_torch.profile_ivc [--steps 2]

Runs IVCState.init and `--steps` steps on the first CUDA device and traces
the last one with torch.profiler (CPU and CUDA activities).  Device busy
time is the sum of the CUDA kernels' self time in the trace; the idle
share is 1 - busy / wall.  Prints one JSON line; fails if the trace holds
no device time.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import device as devmod
from .frontend.ivc import IVCState, _params_from_reference_fixture


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    dev = devmod.cuda()
    state = IVCState.init(_params_from_reference_fixture(), dev)
    for _ in range(args.steps - 1):
        state = state.prove()
    devmod.sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = state.prove()
        devmod.sync(dev)
        wall = time.perf_counter() - t0
    kernels = sorted(((e.key, e.self_device_time_total / 1e6, e.count)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    if busy <= 0:
        raise RuntimeError("the trace holds no device time")
    print(json.dumps({
        "card": devmod.card_line(), "step": state.i, "wall_s": wall,
        "split_s": state.timings, "device_busy_s": busy, "idle_share": 1 - busy / wall,
        "top_kernels": [{"name": k[0][:80], "device_s": k[1], "calls": k[2]}
                        for k in kernels[:8]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
