"""Frontend eDSL: typed wires over a global circuit builder (port of
halo_tpu/frontend/__init__.py).

Mirrors reference crates/plonk/src/frontend/mod.rs: a process-global
Frontend holds the CircuitSpec under construction; Call binds values via a
TraceBuilder and produces the (fp, fq) trace pair through the port's
plonk.trace.trace_pair, on an explicit device.
"""

from __future__ import annotations

from ..plonk.circuit import CircuitSpec, TraceBuilder
from ..plonk.trace import trace_pair


class Frontend:
    def __init__(self):
        self.circuit = CircuitSpec()


_CURRENT = Frontend()


def current() -> Frontend:
    return _CURRENT


def reset() -> None:
    global _CURRENT
    _CURRENT = Frontend()


class Call:
    """Binds witness/public-input values and produces the trace pair."""

    def __init__(self):
        # Snapshot the spec WITHOUT deepcopy (profiled 3.4 s/step at 2^16:
        # ~640k object copies).  TraceBuilder only READS the spec; Gate /
        # Wire are immutable records, so a shallow gate-list copy plus
        # copied counter lists fully isolates this Call from later
        # mutations of the global frontend circuit.
        src = current().circuit
        spec = CircuitSpec.__new__(CircuitSpec)
        spec.gates = list(src.gates)
        spec.witness_wire_count = list(src.witness_wire_count)
        spec.public_input_wire_count = list(src.public_input_wire_count)
        spec.message_pass_wire_count = list(src.message_pass_wire_count)
        spec.output_wire_count = list(src.output_wire_count)
        spec.row_count = list(src.row_count)
        spec.wire_count = list(src.wire_count)
        spec.zero = list(src.zero)
        spec.one = list(src.one)
        self.trace_builder = TraceBuilder(spec)

    def witness(self, ws, value: int) -> None:
        self.trace_builder.witness(ws.wire, value)

    def witness_bool(self, wb, b: bool) -> None:
        self.trace_builder.witness(wb.wire, 1 if b else 0)

    def witness_affine(self, wp, affine) -> None:
        # affine: host (x, y) tuple or None for identity -> (0,0)
        x, y = (0, 0) if affine is None else affine
        self.trace_builder.witness(wp.x.wire, x)
        self.trace_builder.witness(wp.y.wire, y)

    def public_input(self, ws, value: int) -> None:
        self.trace_builder.public_input(ws.wire, value)

    def public_input_affine(self, wp, affine) -> None:
        x, y = (0, 0) if affine is None else affine
        self.trace_builder.public_input(wp.x.wire, x)
        self.trace_builder.public_input(wp.y.wire, y)

    def trace(self, device, accs_prev=None, static_circuits=None):
        return trace_pair(self.trace_builder, device, accs_prev, static_circuits)


from . import primitives  # noqa: E402,F401
from .primitives import WireAffine, WireBool, WireScalar  # noqa: E402,F401
