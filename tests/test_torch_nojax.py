"""The port runs with neither JAX nor the JAX package importable.

A subprocess blocks `import jax` and `import halo_tpu` (sys.modules[name] =
None, so any attempt raises ImportError), imports halo_tpu_torch and
chip_smoke, proves the golden Pallas circuit on the CPU (its SRS derived by
the port), checks the bytes against tests/fixtures/proof_pallas.bin,
verifies, builds the IVC start state, imports the parallel layer
(halo_tpu_torch.parallel), and reports every jax or halo_tpu module that
got loaded (there must be none).  chip_smoke.py itself must
refuse to run without a GPU, and outside a checkout of the repository.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import json, os, sys
sys.modules["jax"] = None
sys.modules["halo_tpu"] = None
sys.path.insert(0, sys.argv[1])
import torch
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
import halo_tpu_torch, chip_smoke
from halo_tpu_torch.parallel import mesh, msm, ntt, pipeline
from halo_tpu_torch.frontend.ivc import IVCState, _params_from_reference_fixture
from halo_tpu_torch.plonk import protocol, trace
from halo_tpu_torch.plonk.circuit import TRACE_CURVE

fp_data, _ = chip_smoke.golden_builder().trace()
cfg = TRACE_CURVE[0]
circuit, x, w = trace.Trace.new(cfg, fp_data, "cpu").consume()
proof = protocol.naive_prover(cfg, circuit, x, w, "cpu")
protocol.verify(cfg, proof, circuit, x, "cpu")
gold = open(sys.argv[1] + "/tests/fixtures/proof_pallas.bin", "rb").read()
state = IVCState.init(_params_from_reference_fixture(), "cpu")
state.verify()
loaded = sorted(k for k, v in sys.modules.items()
                if v is not None and (k.split(".")[0] in ("jax", "jaxlib", "halo_tpu")))
print(json.dumps({"equal": proof.to_bytes(cfg) == gold, "ivc_pi": len(state.fq_public_input.public_inputs),
                  "loaded": loaded}))
"""


def test_prove_and_verify_without_jax():
    res = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"equal": True, "ivc_pi": 725, "loaded": []}


def _cpu_env() -> dict:
    return {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def _no_ok_line(stdout: str) -> bool:
    return not any('"ok": true' in line for line in stdout.splitlines())


def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path):
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=_cpu_env())
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert _no_ok_line(res.stdout)

    # a directory that holds chip_smoke.py and nothing else of the repository
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env=_cpu_env())
    assert res.returncode != 0
    assert "checkout of the repository" in res.stderr
    assert _no_ok_line(res.stdout)
