"""Build, bind and count the port's CUDA kernels (csrc/kernels.cu).

Route: nvcc builds csrc/kernels.cu into a shared library with a plain C
interface (`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`), bound with ctypes.  The build runs at first use, into
build/halo_tpu_torch/ under the repository root, keyed by a hash of the
sources, and never when a module is imported: the CPU tests import every
module on a machine without nvcc.  `registers` and `local_bytes` ask the
loaded library for each kernel's registers and local memory (spill) bytes
per thread (cudaFuncGetAttributes).

Each C entry returns cudaGetLastError(); `launch` raises on any non-zero
value.  A C entry launches on the runtime's current device, so `launch`
makes the device of its first tensor argument current and passes that
device's current stream: a kernel on cuda:1 tensors is enqueued on cuda:1,
and a thread that set its own stream (parallel/pipeline.py) launches
there.  LAUNCHES counts launches per kernel: a wrapper adds one exactly
where it launches its kernel, so a run can show that its main path went
through every kernel.  COPIES counts the operand copies a wrapper makes
before a launch because the kernel cannot read the operand in place
(field_add and field_sub read any view whose lanes are contiguous).  Both
are summed over every thread under `_lock`; thread_launches() gives the
calling thread's own count, for a check that must not see another
thread's launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "field.cuh", CSRC / "kernels.cu")
BUILD_DIR = _PKG.parent / "build" / "halo_tpu_torch"

NAMES = ("field_mul", "ntt_butterfly", "ec_padd", "ec_pmadd_scan", "ec_pmadd", "ec_pdbl",
         "ec_smul", "field_add", "field_sub", "poseidon_permute", "ntt_pass")
LAUNCHES: dict[str, int] = {name: 0 for name in NAMES}
COPIES: dict[str, int] = {name: 0 for name in NAMES}

_vp, _ll, _int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "halo_field_mul": [_vp, _vp, _vp, _ll, _int, _int, _vp],
    "halo_ntt_butterfly": [_vp, _vp, _vp, _ll, _ll, _ll, _ll, _int, _vp],
    "halo_ec_padd": [_vp, _vp, _vp, _ll, _int, _vp],
    "halo_ec_pmadd_scan": [_vp, _vp, _vp, _vp, _ll, _ll, _ll, _int, _vp],
    "halo_ec_pmadd": [_vp, _vp, _vp, _ll, _int, _int, _vp],
    "halo_ec_pdbl": [_vp, _vp, _ll, _int, _vp],
    "halo_ec_smul": [_vp, _vp, _vp, _ll, _int, _int, _vp],
    "halo_field_add": [_vp, _vp, _vp, _ll, _ll, _int, _ll, _int, _int, _vp],
    "halo_field_sub": [_vp, _vp, _vp, _ll, _ll, _int, _ll, _int, _int, _vp],
    "halo_poseidon_permute": [_vp, _vp, _vp, _ll, _int, _vp],
    "halo_ntt_pass": [_vp, _vp, _vp, _vp, _ll, _int, _int, _int, _int, _vp],
    "halo_kernel_registers": [_vp, _vp],
}

_lib = None
_lock = threading.Lock()
_thread = threading.local()  # .launches: this thread's launches per kernel
BUILD_SECONDS: float | None = None


def reset_counts() -> None:
    with _lock:
        for name in NAMES:
            LAUNCHES[name] = 0
            COPIES[name] = 0


def counts() -> dict[str, int]:
    with _lock:
        return dict(LAUNCHES)


def copies() -> dict[str, int]:
    with _lock:
        return dict(COPIES)


def count_copy(name: str) -> None:
    with _lock:
        COPIES[name] += 1


def thread_launches(name: str) -> int:
    """Launches of `name` made by the calling thread since it started
    (reset_counts does not reset them)."""
    return getattr(_thread, "launches", {}).get(name, 0)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def library_path() -> Path:
    tag = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES)).hexdigest()[:16]
    return BUILD_DIR / f"libhalo_kernels-{tag}.so"


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, BUILD_SECONDS
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC),
                   "-o", str(tmp), str(CSRC / "kernels.cu")]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        BUILD_SECONDS = time.perf_counter() - t0
        _lib = lib
        return lib


# the Fp instances halo_kernel_registers reports, in its order; ec_padd,
# ec_pmadd_scan and ec_smul once for each thread-group size G
REGISTER_KEYS = ("field_mul", "ntt_butterfly", "ec_padd G1", "ec_padd G2", "ec_padd G4",
                 "ec_pmadd_scan G1", "ec_pmadd_scan G2", "ec_pmadd_scan G4", "ec_pmadd",
                 "ec_pdbl", "ec_smul G1", "ec_smul G2", "ec_smul G4", "field_add", "field_sub",
                 "poseidon_permute", "ntt_pass")


def _resources() -> tuple[dict[str, int], dict[str, int]]:
    regs = (ctypes.c_int * len(REGISTER_KEYS))()
    local = (ctypes.c_int * len(REGISTER_KEYS))()
    err = build().halo_kernel_registers(regs, local)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
    return dict(zip(REGISTER_KEYS, regs)), dict(zip(REGISTER_KEYS, local))


def registers() -> dict[str, int]:
    """Registers per thread of each kernel instance of the loaded library."""
    return _resources()[0]


def local_bytes() -> dict[str, int]:
    """Local memory bytes per thread (register spills) of each instance."""
    return _resources()[1]


def launch(name: str, *args) -> None:
    """Call C entry halo_<name> with `args`, each tensor passed as its data
    pointer, under the device of the first tensor (switched to only when
    another is current) and on that device's current stream (the calling
    thread's); count the launch; raise on a launch error."""
    lib = build()
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    entry, stream = getattr(lib, "halo_" + name), torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        err = entry(*ptrs, stream)
    else:  # the runtime's current device is the one the entry launches on
        with torch.cuda.device(dev):
            err = entry(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    with _lock:
        LAUNCHES[name] += 1
    mine = _thread.__dict__.setdefault("launches", {})
    mine[name] = mine.get(name, 0) + 1


def check_cuda(*tensors: torch.Tensor, contiguous: bool = True) -> None:
    """The argument checks every wrapper makes before a launch: int32 word
    tensors on one device, contiguous unless the kernel reads strides."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"expected torch.int32, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
