"""What chip_smoke.py and kernel_ab.py measure the kernels with: each
kernel's work and its least time on the card, the two timers, and the
benchmark circuit.

work(name, ...) is the one table of each kernel's bytes (each input read
once, each output written once) and field products per launch.  bound()
turns them into the least time on an H100 SXM: the larger of the bytes
over 3.35 TB/s and the 32-bit multiply-adds (136 per field product, a
dense 8-word CIOS) over 16.7 T/s (132 SMs x 64 multiply-adds per clock x
1.98 GHz, the integer rate at the 700 W limit).

host_paced_ms() times wrapper calls back to back between two CUDA events:
for a kernel shorter than the host's issue rate of its Python wrapper
(~0.02-0.03 ms) it reads that rate.  device_ms() replays the same calls
captured in a CUDA graph, so no host time lies between the launches.
traced_device_ms() sums the device time of every CUDA kernel and copy
in a torch.profiler trace of the calls: for composites that a graph
cannot capture (a host-to-device copy inside), such as another tree's
scalar_mul_rows.

The module imports nothing of the package at import time (torch and the
circuit are imported inside the functions), so kernel_ab.py can load it
into a worker that imports another checkout's halo_tpu_torch.
"""

from __future__ import annotations

import random

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
FE_MUL_OPS = 136  # 32x32-bit multiply-adds in one dense 8-word CIOS product
# 32-bit ops of one field add: the 8-word add chain, the 8-word subtract of
# p and the 8-word select; counted at the multiply-add rate, so work()
# gives an add as FE_ADD_OPS / FE_MUL_OPS of a product
FE_ADD_OPS = 24

# ec_padd, ec_pmadd, ec_pdbl: (bytes, field products) per lane
_POINT_WORK = {"ec_padd": (288, 14), "ec_pmadd": (256, 13), "ec_pdbl": (192, 9)}
SMUL_STEPS = 255  # ec_smul: one ec_pdbl and one ec_pmadd per scalar bit
POSEIDON_ROUNDS = 55  # poseidon_permute: 12 sbox products, 9 MDS products, 9 adds a round
POSEIDON_CONSTS = 174  # the MDS and the round constants, 32 bytes each


def work(name: str, lanes: int = 0, *, bcast: bool = False, half: int = 0, R: int = 0,
         F: int = 0, npts: int = 0, log_n: int = 0, s0: int = 0, j: int = 0) -> tuple[int, int]:
    """(bytes, field products) of one launch.  field_mul: lanes, bcast (b
    is one element); field_add, field_sub: lanes, bcast (one operand is
    one element), no product; ntt_butterfly: lanes of the (8, lanes) input, half;
    ntt_pass: lanes, s0, j (stages s0 + 1 .. s0 + j), bcast (the n^-1
    product of an inverse's last pass), the twiddles of its last stage
    read once (the earlier stages' are among them), the products of its
    stages but those by W[0] = 1 (stage s: n/2 - n/2^s a transform);
    "ntt", a whole transform of (8, lanes) = k of size 2^log_n, not one
    launch: its input read once, its output written once, the n/2
    twiddles once, n/2 log n - (n - 1) products a transform (stages 1 ..
    log_n as ntt_pass counts them) and, with bcast (an inverse), one more
    an element;
    ec_pmadd_scan: R steps x F lanes over an SRS table of npts points (a
    point is read once however often it is gathered); ec_smul: lanes,
    bcast (one base for every lane), the products of the ec_pdbl and
    ec_pmadd launches it replaces; poseidon_permute: lanes (states), the
    constants read once, its adds as fractions of a product (FE_ADD_OPS);
    the point kernels: lanes."""
    if name == "field_mul":
        return (64 * lanes + 32 if bcast else 96 * lanes), lanes
    if name in ("field_add", "field_sub"):
        return (64 * lanes + 32 if bcast else 96 * lanes), 0
    if name == "ntt_butterfly":
        return 64 * lanes + 32 * half, lanes // 2
    if name in ("ntt_pass", "ntt"):
        if name == "ntt":
            s0, j = 0, log_n
        products = sum(lanes // 2 - (lanes >> s) for s in range(s0 + 1, s0 + j + 1))
        return (64 * lanes + 32 * (1 << (s0 + j - 1)) + (32 if bcast else 0),
                products + (lanes if bcast else 0))
    if name == "ec_pmadd_scan":
        rf = R * F
        return 64 * min(npts, rf) + 5 * rf + 96 * rf, 13 * rf
    if name == "ec_smul":
        step = _POINT_WORK["ec_pdbl"][1] + _POINT_WORK["ec_pmadd"][1]
        return 32 * lanes + (64 if bcast else 64 * lanes) + 96 * lanes, SMUL_STEPS * step * lanes
    if name == "poseidon_permute":
        per_state = POSEIDON_ROUNDS * (12 + 9 + 9 * FE_ADD_OPS / FE_MUL_OPS)
        return 192 * lanes + 32 * POSEIDON_CONSTS, per_state * lanes
    per_bytes, per_products = _POINT_WORK[name]
    return per_bytes * lanes, per_products * lanes


def bound(nbytes: float, products: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = products * FE_MUL_OPS / IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_paced_ms(fn, iters: int) -> float:
    """ms per call of `iters` calls back to back between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device ms per call: `iters` calls captured in a CUDA graph, replayed
    three times."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def traced_device_ms(fn, iters: int) -> float:
    """Device ms per call: the self time of the CUDA kernels and copies in
    a torch.profiler trace of `iters` calls, after one untraced call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    if busy_us <= 0:
        raise RuntimeError("the trace holds no device time")
    return busy_us / 1e3 / iters


def poseidon_chain(target_rows: int, seed: int):
    """bench.py's circuit (bench.py:227-250): 12 rows per permutation; a
    TraceBuilder with its three witnesses drawn from `seed`."""
    from halo_tpu_torch.plonk.circuit import TRACE_CURVE, CircuitSpec, TraceBuilder

    rng = random.Random(seed)
    spec = CircuitSpec()
    w = [spec.fp_witness() for _ in range(3)]
    wires = tuple(w)
    for _ in range(max(1, (target_rows - 8) // 12)):
        for i in range(11):
            wires = spec.poseidon(i, wires)
        wires = spec.poseidon_finish(wires)
    spec.output_gate(wires[0])
    tb = TraceBuilder(spec)
    for wi in w:
        tb.witness(wi, rng.randrange(TRACE_CURVE[0].r))
    return tb
