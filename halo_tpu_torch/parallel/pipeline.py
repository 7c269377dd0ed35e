"""Curve pipelining (port of halo_tpu/parallel/pipeline.py:24-53).

The two proofs of an IVC step, Pallas and Vesta, are independent
(reference ivc/mod.rs:648-649).  run_disjoint runs them at once, one
thread a task, each on its own sub-mesh (split_mesh): on disjoint cards
when the mesh has enough, else on shared single-device sub-meshes.

In torch the current stream is per thread.  A task on CUDA runs with its
sub-mesh's first device current and on streams of its own, one per device
of its sub-mesh (torch.cuda.Stream), so its kernels never queue behind the
other task's.  Each task stream first waits for the caller's stream on
that device: the tensors the caller made before the call (the SRS, the
traces' device mirrors) are complete before a task reads them.  After the
join, the caller's streams wait for every task stream, so the caller's
later work sees what the tasks wrote.  Python's global interpreter lock
lets only one task run Python at a time: what overlaps is one task's
device work and waits (ctypes launches and stream synchronisations
release the lock) with the other's host work.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

from .mesh import Mesh


def split_mesh(mesh: Mesh, k: int) -> list[Mesh]:
    """k disjoint sub-meshes of contiguous equal parts; with fewer devices
    than k, single-device sub-meshes devices[i % len], shared."""
    devs = mesh.devices
    if len(devs) < k:
        return [Mesh((devs[i % len(devs)],)) for i in range(k)]
    per = len(devs) // k
    return [Mesh(devs[i * per:(i + 1) * per]) for i in range(k)]


def run_disjoint(mesh: Mesh, tasks) -> list:
    """[task(sub) for each task and its sub-mesh], the tasks run at once in
    threads; re-raises a task's exception."""
    subs = split_mesh(mesh, len(tasks))
    streams = []
    for sub in subs:
        mine = {}
        for dev in dict.fromkeys(d for d in sub.devices if d.type == "cuda"):
            mine[dev] = torch.cuda.Stream(dev)
            mine[dev].wait_stream(torch.cuda.current_stream(dev))
        streams.append(mine)

    def run(task, sub, mine):
        with contextlib.ExitStack() as stack:
            # setting a stream makes its device current: the first device last
            for s in reversed(list(mine.values())):
                stack.enter_context(torch.cuda.stream(s))
            if mine:
                stack.enter_context(torch.cuda.device(sub.devices[0]))
            return task(sub)

    try:
        with ThreadPoolExecutor(max_workers=len(tasks)) as ex:
            futs = [ex.submit(run, t, s, m) for t, s, m in zip(tasks, subs, streams)]
            return [f.result() for f in futs]
    finally:
        for mine in streams:
            for dev, s in mine.items():
                torch.cuda.current_stream(dev).wait_stream(s)
