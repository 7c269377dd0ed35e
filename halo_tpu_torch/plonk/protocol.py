"""PLONK entry points of the port (counterpart of
halo_tpu/plonk/protocol.py naive_prover / verify).

naive_prover always runs the tensor prover (protocol_device.py) on the
given device.  verify is halo_tpu's succinct verifier (host transcript
and succinct PCDL checks) followed by the port's decider, whose MSM runs
on the device.
"""

from __future__ import annotations

from halo_tpu.curves import CurveCfg
from halo_tpu.plonk.protocol import PlonkProof, verify_succinct
from halo_tpu.plonk.trace import PlonkCircuit, PlonkPublicInputs, PlonkWitness

from .. import acc as acc_mod
from .protocol_device import naive_prover_device


def naive_prover(cfg: CurveCfg, circuit: PlonkCircuit, x: PlonkPublicInputs,
                 w: PlonkWitness, device) -> PlonkProof:
    return naive_prover_device(cfg, circuit, x, w, device)


def verify(cfg: CurveCfg, proof: PlonkProof, circuit: PlonkCircuit, x: PlonkPublicInputs,
           device) -> None:
    """Raises PlonkVerifyError / AccumulationError / PcdlCheckError."""
    verify_succinct(cfg, proof, circuit, x)
    acc_mod.decider(cfg, proof.acc_next, device)
