"""The circuit builder a port user builds circuits with.

Circuits, witnesses and trace data are host objects with no device work
and no jax: the port uses halo_tpu's arithmetizer (halo_tpu/plonk/
circuit.py) as it is, and this module is where the port's users and
chip_smoke.py get it from.  TRACE_CURVE[i] is the curve whose proof
covers field FP (i = 0) or FQ (i = 1).
"""

from halo_tpu.plonk.circuit import FP, FQ, TRACE_CURVE, CircuitSpec, TraceBuilder, TraceData

__all__ = ["FP", "FQ", "TRACE_CURVE", "CircuitSpec", "TraceBuilder", "TraceData"]
