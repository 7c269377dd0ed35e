"""Where an IVC step's time goes on the card: wall time, device busy time
and the device's idle share of one warm step, the device time of each of
the port's kernels, and the shapes each kernel was launched at.

    python3 -m halo_tpu_torch.profile_ivc [--steps 2]

Runs IVCState.init and `--steps` steps on the first CUDA device, timing
the untraced ones, and traces the last one with torch.profiler (CPU and
CUDA activities).  Device busy time is the union of the intervals in which
the trace shows device activity (kernels, copies) on any stream; the idle
share is 1 - busy / wall.  The provers of a step run at once on two
streams (frontend/ivc.py), so the trace also gives each stream's busy
time and the overlap: the time in which two or more streams were busy at
once; the sum of the CUDA kernels' self time (what busy time meant before
the provers ran at once) is kept beside it.  The traced step's peak
device memory is torch.cuda.max_memory_allocated.  The device time
and launches of kernels that are not the port's (torch's elementwise,
reduce, copy and cat kernels) are summed apart.  The host side is
summarised by the CPU ops and CUDA runtime calls of most self time, and
by the calls and host seconds of cudaLaunchKernel, cudaStreamSynchronize,
cudaMemcpyAsync and aten::any (HOST_CALLS: the launches, the host's
waits for the card, the copies, and the any() of a carry loop).  During
the traced step the kernel wrappers of ops/mont.py are wrapped here to
count launches by shape (field_mul, field_add, field_sub: lanes and
broadcast; ntt_butterfly: lanes and half; ntt_pass: lanes, log_n, s0, j
and the inverse's scale; ec_padd, ec_pmadd, ec_pdbl:
lanes; ec_pmadd_scan: R x F; ec_smul: lanes and broadcast); the wrappers
themselves are not touched (the counts take a lock: the provers' threads
share them).  Each step's prover phases per curve
(round5.open+accumulate: the IPA opens and the accumulation) come from
the provers' RoundTimer lines (phase_times).  Prints one JSON line;
fails if the trace holds no device time.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import logging
import re
import threading
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import device as devmod
from .frontend.ivc import IVCState, _params_from_reference_fixture
from .ops import mont

KERNELS = ("field_mul", "ntt_butterfly", "ec_padd", "ec_pmadd_scan", "ec_pmadd", "ec_pdbl",
           "ec_smul", "field_add", "field_sub", "ntt_pass")
HOST_CALLS = ("cudaLaunchKernel", "cudaStreamSynchronize", "cudaMemcpyAsync", "aten::any")
_PHASE_LINE = re.compile(r"^(.*): ([^:\s]+): ([0-9.]+)s$")


@contextlib.contextmanager
def phase_times():
    """While open, collect the provers' RoundTimer phases as (label,
    phase, seconds), from the "<label>: <phase>: <seconds>s" lines that
    utils/timing.py logs to the halo_tpu_torch.timing logger (set to
    DEBUG here, which turns the timers on)."""
    out = []

    class _Collect(logging.Handler):
        def emit(self, record):
            m = _PHASE_LINE.match(record.getMessage())
            if m:
                out.append((m.group(1), m.group(2), float(m.group(3))))

    log = logging.getLogger("halo_tpu_torch.timing")
    handler, level = _Collect(), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    try:
        yield out
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def phase_by_curve(phases, phase: str = "round5.open+accumulate") -> dict:
    """{curve: [seconds of `phase` in each proof, in order]}; the curve is
    the first word in the prover label's brackets."""
    out = collections.defaultdict(list)
    for label, name, sec in phases:
        if name == phase and "[" in label:
            out[label.split("[", 1)[1].split(",")[0]].append(sec)
    return dict(out)


def _shape_key(name: str, args) -> str:
    if name in ("field_mul", "field_add", "field_sub"):
        a, b = args[1], args[2]
        n = max(a.shape[1:].numel(), b.shape[1:].numel())
        return f"{n}{' bcast' if min(a.shape[1:].numel(), b.shape[1:].numel()) == 1 else ''}"
    if name == "ntt_butterfly":
        return f"{args[1].shape[1]} half {args[3]}"
    if name == "ntt_pass":
        scale = " scale" if len(args) > 6 and args[6] is not None else ""
        return f"{args[1].shape[1]} log_n {args[3]} s0 {args[4]} j {args[5]}{scale}"
    if name == "ec_pmadd_scan":
        R, F = args[2].shape
        return f"R {R} F {F}"
    if name == "ec_smul":
        xy, k = args[1], args[2]
        return f"{k.shape[1]}{' bcast' if xy.shape[1] == 1 else ''}"
    return str(args[1].shape[2:].numel())


class _ShapeCounter:
    """Counts each mont wrapper's calls by shape while installed."""

    def __init__(self):
        self.counts = {k: collections.Counter() for k in KERNELS}
        self._saved = {}
        self._lock = threading.Lock()

    def __enter__(self):
        for name in KERNELS:
            fn = getattr(mont, name, None)
            if fn is None:  # an older tree, run by kernel_ab.py, has fewer kernels
                continue
            self._saved[name] = fn

            def counted(*args, _name=name, _fn=fn):
                key = _shape_key(_name, args)
                with self._lock:
                    self.counts[_name][key] += 1
                return _fn(*args)

            setattr(mont, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(mont, name, fn)

    def as_dict(self) -> dict:
        return {k: dict(sorted(c.items(), key=lambda kv: -kv[1])) for k, c in self.counts.items()}


def _port_kernel(key: str) -> str | None:
    """The port kernel a CUDA kernel name in the trace belongs to
    (field_add and field_sub are k_field_addsub<F, false / true>)."""
    if "k_field_addsub<" in key:
        return "field_sub" if "true>" in key else "field_add"
    for name in sorted(KERNELS, key=len, reverse=True):
        if f"k_{name}<" in key or f"k_{name}(" in key:
            return name
    return None


def _merged(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def stream_times(prof) -> dict:
    """From a trace's device activity (kineto events on a CUDA device:
    kernels, copies, sets): seconds of the union over all streams
    ("busy_s"), of each stream's union ("streams"), and of the time in
    which at least two streams were busy at once ("overlap_s")."""
    by_stream = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            by_stream[(e.device_index(), e.device_resource_id())].append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    merged = {k: _merged(v) for k, v in by_stream.items()}
    edges = sorted((t, step) for iv in merged.values() for a, b in iv for t, step in ((a, 1), (b, -1)))
    overlap, active, prev = 0, 0, None
    for t, step in edges:
        if active >= 2:
            overlap += t - prev
        active, prev = active + step, t
    busy = sum(b - a for a, b in _merged(iv for v in merged.values() for iv in v))
    return {"busy_s": busy / 1e9, "overlap_s": overlap / 1e9,
            "streams": {f"{dev}:{sid}": sum(b - a for a, b in iv) / 1e9
                        for (dev, sid), iv in sorted(merged.items())}}


def profile_step(dev: torch.device, steps: int) -> dict:
    """Init, steps - 1 untraced steps, then one traced step."""
    state = IVCState.init(_params_from_reference_fixture(), dev)
    untraced, round5 = [], []
    for _ in range(steps - 1):
        with phase_times() as phases:
            t0 = time.perf_counter()
            state = state.prove()
            devmod.sync(dev)
            untraced.append(time.perf_counter() - t0)
        round5.append(phase_by_curve(phases))
    torch.cuda.reset_peak_memory_stats(dev)
    with phase_times() as phases, _ShapeCounter() as shapes, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = state.prove()
        devmod.sync(dev)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    round5.append(phase_by_curve(phases))
    streams = stream_times(prof)
    averages = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e6, e.count)
                      for e in averages if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    host_ops = sorted(((e.key, e.self_cpu_time_total / 1e6, e.count)
                       for e in averages if e.device_type == DeviceType.CPU),
                      key=lambda k: -k[1])
    kernel_sum = sum(k[1] for k in kernels)
    busy = streams["busy_s"]
    if busy <= 0 or kernel_sum <= 0:
        raise RuntimeError("the trace holds no device time")
    port = {name: {"device_s": 0.0, "calls": 0} for name in KERNELS}
    other = {"device_s": 0.0, "calls": 0}
    for key, dev_s, calls in kernels:
        name = _port_kernel(key)
        slot = port[name] if name is not None else other
        slot["device_s"] += dev_s
        slot["calls"] += calls
    host_calls = {name: {"calls": 0, "host_s": 0.0} for name in HOST_CALLS}
    for e in averages:
        if e.key in host_calls:
            host_calls[e.key]["calls"] += e.count
            host_calls[e.key]["host_s"] += e.self_cpu_time_total / 1e6
    return {
        "card": devmod.card_line(), "step": state.i, "untraced_steps_s": untraced, "wall_s": wall,
        "split_s": state.timings, "round5_open_accumulate_s": round5, "device_busy_s": busy,
        "idle_share": 1 - busy / wall, "device_kernel_sum_s": kernel_sum,
        "stream_overlap_s": streams["overlap_s"], "stream_busy_s": streams["streams"],
        "peak_memory_gib": peak / 2**30, "port_kernels": port, "other_kernels": other,
        "host_calls": host_calls, "launch_shapes": shapes.as_dict(),
        "top_kernels": [{"name": k[0][:80], "device_s": k[1], "calls": k[2]}
                        for k in kernels[:8]],
        "top_host_ops": [{"name": k[0][:80], "host_s": k[1], "calls": k[2]}
                         for k in host_ops[:15]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    print(json.dumps(profile_step(devmod.cuda(), args.steps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
