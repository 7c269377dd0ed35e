"""The arithmetizer: gate DAG + witness-solving trace builder (the port's
copy of halo_tpu/plonk/circuit.py; circuits, witnesses and trace data are
host objects with no device work).

Re-implements the reference arithmetizer semantics
(crates/plonk/src/circuit/circuit_spec.rs, trace_builder.rs): every
statement arithmetizes simultaneously into TWO traces, one over Fp (proven
on Pallas, whose scalar field is Fp) and one over Fq, with values crossing
between them only through message-pass gates that become public-input rows
in the receiving circuit.

Row layout per trace: [public-input rows][message-pass rows][gate rows],
padded to next_power_of_two().max(4) (trace_builder.rs:30-55,111-112).

Affine points inside the circuit use the (0,0)-identity convention with
helper witnesses (alpha,beta,gamma,delta,lambda) making the add/double
formulas complete (trace_builder.rs:942-999).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

from ..curves import PALLAS, VESTA, CurveCfg, ec_add
from ..fields import FP_MOD, FQ_MOD, inv
from ..poseidon.constants import FP_MDS, FP_ROUND_CONSTANTS, FQ_MDS, FQ_ROUND_CONSTANTS
from .constants import Q_POLYS, R_POLYS, W_POLYS

FP, FQ = 0, 1  # PastaFieldId: Fp = Pallas scalar; Fq = Pallas base
MODS = (FP_MOD, FQ_MOD)
# trace over fid f is proven on the curve whose SCALAR field is MODS[f]
TRACE_CURVE = (PALLAS, VESTA)  # PALLAS scalar field = Fp
# affine coordinates in field f live on the curve whose BASE field is MODS[f]
COORD_CURVE = (VESTA, PALLAS)
POSEIDON_RC = (FP_ROUND_CONSTANTS, FQ_ROUND_CONSTANTS)
POSEIDON_MDS = (FP_MDS, FQ_MDS)


class Wire(NamedTuple):
    fid: int
    id: int
    node: int
    out_id: int


class SlotId(NamedTuple):
    row: int  # 1-indexed
    col: int  # 1-indexed

    def to_usize(self, rows: int) -> int:
        return self.row - 1 + (self.col - 1) * rows

    def to_scalar(self, rows: int) -> int:
        return self.row + (self.col - 1) * rows

    @classmethod
    def from_usize(cls, u: int, rows: int) -> "SlotId":
        return cls(1 + (u % rows), 1 + (u // rows))


@dataclass
class Gate:
    kind: str
    ins: tuple
    outs: tuple
    data: object = None


def petgraph_toposort(spec: "CircuitSpec") -> list[int]:
    """Exact replica of petgraph::algo::toposort's DFS node order.

    The reference assigns trace rows by walking the gate DAG in the order
    petgraph's toposort emits (trace_builder.rs:153), so bit-exact q/r/sigma
    polynomials require reproducing it precisely: an explicit-stack DFS over
    node identifiers 0..n, where visiting a node pushes its not-yet-
    discovered successors in reverse edge-insertion order (petgraph iterates
    a node's outgoing edges most-recently-added first), and nodes are
    appended to the finish stack when popped; the reversed finish stack is
    the topological order.  Edge insertion order: one edge per gate input,
    in input-declaration order, at gate creation (circuit_spec.rs:257-506).
    """
    n = len(spec.gates)
    out_edges: list[list[int]] = [[] for _ in range(n)]
    for gi, g in enumerate(spec.gates):
        for w in g.ins:
            out_edges[w.node].append(gi)

    discovered = bytearray(n)
    finished = bytearray(n)
    finish_stack: list[int] = []
    stack: list[int] = []
    for i in range(n):
        if discovered[i]:
            continue
        stack.append(i)
        while stack:
            nx = stack[-1]
            if not discovered[nx]:
                discovered[nx] = 1
                # petgraph pushes neighbors latest-edge-first, so the stack
                # top (visited next) is the EARLIEST-inserted edge's target
                for succ in reversed(out_edges[nx]):
                    if not discovered[succ]:
                        stack.append(succ)
            else:
                stack.pop()
                if not finished[nx]:
                    finished[nx] = 1
                    finish_stack.append(nx)
    finish_stack.reverse()
    return finish_stack


class CircuitSpec:
    def __init__(self, with_consts: bool = True):
        self.gates: list[Gate] = []
        self.witness_wire_count = [0, 0]
        self.public_input_wire_count = [0, 0]
        self.message_pass_wire_count = [0, 0]
        self.output_wire_count = [0, 0]
        self.row_count = [0, 0]
        self.wire_count = [0, 0]
        self.zero: list[Optional[Wire]] = [None, None]
        self.one: list[Optional[Wire]] = [None, None]
        if with_consts:
            # node-index parity with the reference: fp_zero, fp_one, fq_zero,
            # fq_one in THAT creation order (circuit_spec.rs:160-169)
            fp_zero = self.constant(FP, 0)
            fp_one = self.constant(FP, 1)
            fq_zero = self.constant(FQ, 0)
            fq_one = self.constant(FQ, 1)
            self.zero = [fp_zero, fq_zero]
            self.one = [fp_one, fq_one]

    # ---------------- construction helpers ---------------- #

    def _new_wires(self, fid: int, n: int) -> tuple:
        node = len(self.gates)
        out = []
        for i in range(n):
            out.append(Wire(fid, self.wire_count[fid], node, i))
            self.wire_count[fid] += 1
        return tuple(out)

    def _push(self, gate: Gate) -> None:
        self.gates.append(gate)

    # ---------------- gate API (mirrors circuit_spec.rs) ---------------- #

    def witness(self, fid: int) -> Wire:
        self.witness_wire_count[fid] += 1
        (w,) = self._new_wires(fid, 1)
        self._push(Gate("witness", (), (w,)))
        return w

    def public_input(self, fid: int) -> Wire:
        self.public_input_wire_count[fid] += 1
        self.row_count[fid] += 1
        (w,) = self._new_wires(fid, 1)
        self._push(Gate("public_input", (), (w,)))
        return w

    def fp_witness(self) -> Wire:
        return self.witness(FP)

    def fq_witness(self) -> Wire:
        return self.witness(FQ)

    def fp_public_input(self) -> Wire:
        return self.public_input(FP)

    def fq_public_input(self) -> Wire:
        return self.public_input(FQ)

    def constant(self, fid: int, c: int) -> Wire:
        self.row_count[fid] += 1
        (w,) = self._new_wires(fid, 1)
        self._push(Gate("constant", (), (w,), c % MODS[fid]))
        return w

    def add_gate(self, left: Wire, right: Wire) -> Wire:
        assert left.fid == right.fid
        self.row_count[left.fid] += 1
        (out,) = self._new_wires(left.fid, 1)
        self._push(Gate("add", (left, right), (out,)))
        return out

    def mul_gate(self, left: Wire, right: Wire) -> Wire:
        assert left.fid == right.fid
        self.row_count[left.fid] += 1
        (out,) = self._new_wires(left.fid, 1)
        self._push(Gate("mul", (left, right), (out,)))
        return out

    def poseidon(self, round: int, ins: tuple) -> tuple:
        fid = ins[0].fid
        self.row_count[fid] += 1
        outs = self._new_wires(fid, 3)
        rc = POSEIDON_RC[fid]
        r_consts = tuple(rc[5 * round + i // 3][i % 3] for i in range(R_POLYS))
        self._push(Gate("poseidon", tuple(ins), outs, r_consts))
        return outs

    def poseidon_finish(self, ins: tuple) -> tuple:
        fid = ins[0].fid
        self.row_count[fid] += 1
        outs = self._new_wires(fid, 3)
        self._push(Gate("poseidon_end", tuple(ins), outs))
        return outs

    def add_points(self, p: tuple, q: tuple) -> tuple:
        fid = p[0].fid
        self.row_count[fid] += 1
        outs = self._new_wires(fid, 2)
        self._push(Gate("affine_add", (p[0], p[1], q[0], q[1]), outs))
        return outs

    def neg_gate(self, x: Wire) -> Wire:
        fid = x.fid
        self.row_count[fid] += 1
        (out,) = self._new_wires(fid, 1)
        self._push(Gate("negate", (x, self.zero[fid]), (out,)))
        return out

    def inv_gate(self, x: Wire) -> Wire:
        fid = x.fid
        self.row_count[fid] += 1
        (out,) = self._new_wires(fid, 1)
        self._push(Gate("invert", (x, self.one[fid]), (out,)))
        return out

    def assert_eq_gate(self, left: Wire, right: Wire) -> None:
        assert left.fid == right.fid
        self.row_count[left.fid] += 1
        self._push(Gate("assert_eq", (left, right), ()))

    def scalar_mul_pallas(self, scalar: tuple, point: tuple) -> tuple:
        fid = point[0].fid
        self.row_count[fid] += 255 + 1
        outs = self._new_wires(fid, 2)
        self._push(Gate("scalar_mul_pallas", (scalar[0], scalar[1], point[0], point[1]), outs))
        return outs

    def scalar_mul_vesta(self, scalar: Wire, point: tuple) -> tuple:
        fid = point[0].fid
        self.row_count[fid] += 255 + 1
        outs = self._new_wires(fid, 2)
        self._push(Gate("scalar_mul_vesta", (scalar, point[0], point[1]), outs))
        return outs

    def fp_message_pass(self, x: Wire) -> tuple:
        assert x.fid == FP
        fid = FQ
        self.message_pass_wire_count[fid] += 2
        self.row_count[fid] += 2 + 17
        outs = self._new_wires(fid, 2)
        self._push(Gate("fp_message_pass", (x,), outs))
        return outs

    def fq_message_pass(self, x: Wire) -> Wire:
        assert x.fid == FQ
        fid = FP
        self.message_pass_wire_count[fid] += 1
        self.row_count[fid] += 1
        (out,) = self._new_wires(fid, 1)
        self._push(Gate("fq_message_pass", (x,), (out,)))
        return out

    def fp_bool_message_pass(self, x: Wire) -> Wire:
        assert x.fid == FP
        fid = FQ
        self.message_pass_wire_count[fid] += 1
        self.row_count[fid] += 1
        (out,) = self._new_wires(fid, 1)
        self._push(Gate("bool_message_pass", (x,), (out,)))
        return out

    def fq_bool_message_pass(self, x: Wire) -> Wire:
        assert x.fid == FQ
        fid = FP
        self.message_pass_wire_count[fid] += 1
        self.row_count[fid] += 1
        (out,) = self._new_wires(fid, 1)
        self._push(Gate("bool_message_pass", (x,), (out,)))
        return out

    def eq_gate(self, a: Wire, b: Wire) -> Wire:
        fid = a.fid
        self.row_count[fid] += 1
        (out,) = self._new_wires(fid, 1)
        self._push(Gate("eq", (a, b), (out,)))
        return out

    def witness_bool(self, fid: int) -> Wire:
        self.witness_wire_count[fid] += 1
        self.row_count[fid] += 1
        (out,) = self._new_wires(fid, 1)
        self._push(Gate("witness_bool", (), (out,)))
        return out

    def output_gate(self, x: Wire) -> None:
        n = self.output_wire_count[x.fid]
        self.output_wire_count[x.fid] += 1
        self._push(Gate("output", (x,), (), n))


# ---------------- special (0,0)-identity affine helpers ---------------- #


def sp_is_identity(pt: tuple) -> bool:
    return pt == (0, 0)


def sp_add(cfg: CurveCfg, p: tuple, q: tuple) -> tuple:
    a = None if sp_is_identity(p) else p
    b = None if sp_is_identity(q) else q
    r = ec_add(cfg, a, b)
    return (0, 0) if r is None else r


def inv0(m: int, x: int) -> int:
    return 0 if x % m == 0 else inv(x, m)


def batch_inv0(m: int, xs: list[int]) -> list[int]:
    """inv0 over a list with ONE modular exponentiation (Montgomery's trick):
    zero inputs map to zero, exactly like inv0.  The scalar-mul witness
    generator batches ~3 denominators per row through this instead of one
    pow(x, -1, m) each (profiled: 4.6 s of the 9.7 s gate-interpreter time
    at 2^16 rows was modular inversions)."""
    n = len(xs)
    if n == 0:
        return []
    safe = [x % m or 1 for x in xs]
    pref = [1] * (n + 1)
    acc = 1
    for i, x in enumerate(safe):
        acc = acc * x % m
        pref[i + 1] = acc
    tinv = pow(acc, -1, m)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = pref[i] * tinv % m
        tinv = tinv * safe[i] % m
    return [0 if xs[i] % m == 0 else out[i] for i in range(n)]


def affine_add_params(m: int, p: tuple, q: tuple) -> tuple:
    """(alpha, beta, gamma, delta, lambda) (trace_builder.rs:942-967)."""
    xp, yp = p
    xq, yq = q
    alpha = inv0(m, xq - xp)
    beta = inv0(m, xp)
    gamma = inv0(m, xq)
    delta = inv0(m, yq + yp) if xq == xp else 0
    if xq != xp:
        lam = (yq - yp) * inv(xq - xp, m) % m
    elif yp != 0:
        lam = 3 * xp * xp % m * inv(2 * yp, m) % m
    else:
        lam = 0
    return (alpha, beta, gamma, delta, lam)


def poseidon_round_host(fid: int, rc3: tuple, w0: int, w1: int, w2: int) -> tuple:
    m = MODS[fid]
    M = POSEIDON_MDS[fid]
    s = [pow(w, 7, m) for w in (w0, w1, w2)]
    return tuple(
        (rc3[i] + M[i][0] * s[0] + M[i][1] * s[1] + M[i][2] * s[2]) % m for i in range(3)
    )


# ---------------- trace builder ---------------- #


class TraceBuilder:
    def __init__(self, spec: CircuitSpec):
        self.spec = spec
        self.witnesses: list[dict] = [{}, {}]
        self.public_inputs_map: list[dict] = [{}, {}]
        self.row_count = [0, 0]
        self.public_row_count = [0, 0]
        self.message_pass_row_count = [0, 0]

    def witness(self, wire: Wire, v: int) -> None:
        kind = self.spec.gates[wire.node].kind
        if kind not in ("witness", "witness_bool"):
            raise ValueError("The provided wire was not a witness wire!")
        if wire in self.witnesses[wire.fid]:
            raise ValueError("Wire already assigned!")
        self.witnesses[wire.fid][wire] = v % MODS[wire.fid]

    def public_input(self, wire: Wire, v: int) -> None:
        if self.spec.gates[wire.node].kind != "public_input":
            raise ValueError("The provided wire was not a public input wire!")
        if wire in self.public_inputs_map[wire.fid]:
            raise ValueError("Wire already assigned!")
        self.public_inputs_map[wire.fid][wire] = v % MODS[wire.fid]

    def _slots(self, fid: int) -> list[SlotId]:
        row = (
            self.row_count[fid]
            + self.spec.public_input_wire_count[fid]
            + self.spec.message_pass_wire_count[fid]
        )
        self.row_count[fid] += 1
        return [SlotId(row + 1, c + 1) for c in range(W_POLYS)]

    def _pi_slots(self, fid: int) -> list[SlotId]:
        row = self.public_row_count[fid]
        self.public_row_count[fid] += 1
        return [SlotId(row + 1, c + 1) for c in range(W_POLYS)]

    def _mp_slots(self, fid: int) -> list[SlotId]:
        row = self.message_pass_row_count[fid] + self.spec.public_input_wire_count[fid]
        self.message_pass_row_count[fid] += 1
        return [SlotId(row + 1, c + 1) for c in range(W_POLYS)]

    def trace(self):
        """Evaluate gates -> per-field raw trace data (TraceData x2)."""
        spec = self.spec
        rows = [max(4, 1 << (rc - 1).bit_length()) if rc > 1 else 4 for rc in spec.row_count]
        for f in (FP, FQ):
            if len(self.witnesses[f]) != spec.witness_wire_count[f]:
                raise ValueError(
                    f"fid{f}: expected {spec.witness_wire_count[f]} witnesses, "
                    f"got {len(self.witnesses[f])}"
                )
            if len(self.public_inputs_map[f]) != spec.public_input_wire_count[f]:
                raise ValueError("missing public inputs")

        ws = [[[0] * rows[f] for _ in range(W_POLYS)] for f in (FP, FQ)]
        rs = [[[0] * rows[f] for _ in range(R_POLYS)] for f in (FP, FQ)]
        qs = [[[0] * rows[f] for _ in range(Q_POLYS)] for f in (FP, FQ)]
        wire_vals = [[0] * spec.wire_count[FP], [0] * spec.wire_count[FQ]]
        copy = [
            [[] for _ in range(spec.wire_count[FP])],
            [[] for _ in range(spec.wire_count[FQ])],
        ]
        outputs = [[0] * spec.output_wire_count[FP], [0] * spec.output_wire_count[FQ]]
        public_inputs = [[], []]
        message_pass_inputs = [[], []]

        def assign(f, row0, w_row=None, q_row=None, r_row=None):
            if w_row is not None:
                for c, v in enumerate(w_row):
                    ws[f][c][row0] = v % MODS[f]
            if q_row is not None:
                for c, v in enumerate(q_row):
                    qs[f][c][row0] = v % MODS[f]
            if r_row is not None:
                for c, v in enumerate(r_row):
                    rs[f][c][row0] = v % MODS[f]

        node_order = petgraph_toposort(spec)

        for node_idx in node_order:
            g = spec.gates[node_idx]
            k = g.kind
            if k == "witness":
                (out,) = g.outs
                wire_vals[out.fid][out.id] = self.witnesses[out.fid][out]
            elif k == "public_input":
                (out,) = g.outs
                f = out.fid
                slots = self._pi_slots(f)
                v = self.public_inputs_map[f][out]
                public_inputs[f].append(v)
                wire_vals[f][out.id] = v
                row = slots[0].row - 1
                assign(f, row, w_row=[v] + [0] * 15, q_row=[1] + [0] * 9)
                copy[f][out.id].append(slots[0])
            elif k == "constant":
                (out,) = g.outs
                f = out.fid
                c = g.data
                wire_vals[f][out.id] = c
                slots = self._slots(f)
                row = slots[0].row - 1
                assign(f, row, w_row=[c] + [0] * 15, q_row=[1, 0, 0, 0, -c, 0, 0, 0, 0, 0])
                copy[f][out.id].append(slots[0])
            elif k == "output":
                (inp,) = g.ins
                outputs[inp.fid][g.data] = wire_vals[inp.fid][inp.id]
            elif k == "assert_eq":
                lw, rw = g.ins
                f = lw.fid
                slots = self._slots(f)
                l = wire_vals[f][lw.id]
                r = wire_vals[f][rw.id]
                assign(
                    f,
                    slots[0].row - 1,
                    w_row=[l, r] + [0] * 14,
                    q_row=[1, -1] + [0] * 8,
                )
                copy[f][lw.id].append(slots[0])
                copy[f][rw.id].append(slots[1])
            elif k in ("add", "mul"):
                lw, rw = g.ins
                (out,) = g.outs
                f = lw.fid
                m = MODS[f]
                slots = self._slots(f)
                a = wire_vals[f][lw.id]
                b = wire_vals[f][rw.id]
                c = (a + b) % m if k == "add" else a * b % m
                wire_vals[f][out.id] = c
                q_row = [1, 1, -1, 0] + [0] * 6 if k == "add" else [0, 0, -1, 1] + [0] * 6
                assign(f, slots[0].row - 1, w_row=[a, b, c] + [0] * 13, q_row=q_row)
                copy[f][lw.id].append(slots[0])
                copy[f][rw.id].append(slots[1])
                copy[f][out.id].append(slots[2])
            elif k == "poseidon":
                f = g.ins[0].fid
                slots = self._slots(f)
                rc = g.data
                w0, w1, w2 = (wire_vals[f][w.id] for w in g.ins)
                vals = [w0, w1, w2]
                for rnd in range(5):
                    vals += list(
                        poseidon_round_host(f, rc[3 * rnd : 3 * rnd + 3], *vals[-3:])
                    )
                for wire in g.outs:
                    wire_vals[f][wire.id] = vals[15 + wire.out_id]
                assign(
                    f,
                    slots[0].row - 1,
                    w_row=vals[:15] + [0],
                    q_row=[0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
                    r_row=list(rc),
                )
                for i in range(3):
                    copy[f][g.ins[i].id].append(slots[i])
            elif k == "poseidon_end":
                f = g.ins[0].fid
                slots = self._slots(f)
                w0, w1, w2 = (wire_vals[f][w.id] for w in g.ins)
                for wire in g.outs:
                    wire_vals[f][wire.id] = (w0, w1, w2)[wire.out_id]
                assign(f, slots[0].row - 1, w_row=[w0, w1, w2] + [0] * 13, q_row=[0] * 10)
                for i in range(3):
                    copy[f][g.ins[i].id].append(slots[i])
            elif k == "affine_add":
                f = g.ins[0].fid
                m = MODS[f]
                cfg = COORD_CURVE[f]
                slots = self._slots(f)
                xp, yp, xq, yq = (wire_vals[f][w.id] for w in g.ins)
                p, q = (xp, yp), (xq, yq)
                xr, yr = sp_add(cfg, p, q)
                al, be, ga, de, la = affine_add_params(m, p, q)
                for wire in g.outs:
                    wire_vals[f][wire.id] = (xr, yr)[wire.out_id]
                assign(
                    f,
                    slots[0].row - 1,
                    w_row=[xp, yp, xq, yq, xr, yr, al, be, ga, de, la, 0, 0, 0, 0, 0],
                    q_row=[0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
                )
                for i in range(4):
                    copy[f][g.ins[i].id].append(slots[i])
                copy[f][g.outs[0].id].append(slots[4])
                copy[f][g.outs[1].id].append(slots[5])
            elif k == "invert":
                inw, onew = g.ins
                (out,) = g.outs
                f = inw.fid
                m = MODS[f]
                slots = self._slots(f)
                x = wire_vals[f][inw.id]
                x_inv = inv(x, m)
                wire_vals[f][out.id] = x_inv
                assign(
                    f,
                    slots[0].row - 1,
                    w_row=[x, x_inv, 1] + [0] * 13,
                    q_row=[0, 0, -1, 1] + [0] * 6,
                )
                copy[f][inw.id].append(slots[0])
                copy[f][out.id].append(slots[1])
                copy[f][onew.id].append(slots[2])
            elif k == "negate":
                inw, zw = g.ins
                (out,) = g.outs
                f = inw.fid
                m = MODS[f]
                slots = self._slots(f)
                x = wire_vals[f][inw.id]
                xn = (-x) % m
                wire_vals[f][out.id] = xn
                assign(
                    f,
                    slots[0].row - 1,
                    w_row=[x, xn] + [0] * 14,
                    q_row=[1, 1, -1] + [0] * 7,
                )
                copy[f][inw.id].append(slots[0])
                copy[f][out.id].append(slots[1])
                copy[f][zw.id].append(slots[2])
            elif k == "fp_message_pass":
                (inw,) = g.ins
                f_in = inw.fid
                f = FQ  # receiving field
                m = MODS[f]
                x = wire_vals[f_in][inw.id]
                low = x & 1
                high = x >> 1
                # two public-input-style message pass rows
                slots = self._mp_slots(f)
                assign(f, slots[0].row - 1, w_row=[high] + [0] * 15, q_row=[1] + [0] * 9)
                message_pass_inputs[f].append(high)
                copy[f][g.outs[0].id].append(slots[0])
                slots = self._mp_slots(f)
                assign(
                    f,
                    slots[0].row - 1,
                    w_row=[low, low] + [0] * 14,
                    q_row=[-1, 1, 0, 1] + [0] * 6,
                )
                message_pass_inputs[f].append(low)
                copy[f][g.outs[1].id].append(slots[0])
                # 17 range-check rows decomposing the 255 high bits
                acc = 0
                for i in range(17):
                    bits = [(high >> (i * R_POLYS + j)) & 1 for j in range(R_POLYS)]
                    r_row = [pow(2, i * R_POLYS + j, m) for j in range(R_POLYS)]
                    slots = self._slots(f)
                    assign(
                        f,
                        slots[0].row - 1,
                        w_row=[acc] + bits,
                        q_row=[0] * 9 + [1],
                        r_row=r_row,
                    )
                    for j in range(R_POLYS):
                        acc = (acc + bits[j] * r_row[j]) % m
                slots = self._slots(f)
                assign(f, slots[0].row - 1, w_row=[acc] + [0] * 15, q_row=[0] * 10)
                copy[f][g.outs[0].id].append(slots[0])
                wire_vals[f][g.outs[0].id] = high
                wire_vals[f][g.outs[1].id] = low
            elif k == "fq_message_pass":
                (inw,) = g.ins
                f = FP
                v = wire_vals[FQ][inw.id]  # value reinterpreted in Fp (q < p)
                slots = self._mp_slots(f)
                assign(f, slots[0].row - 1, w_row=[v] + [0] * 15, q_row=[1] + [0] * 9)
                message_pass_inputs[f].append(v)
                copy[f][g.outs[0].id].append(slots[0])
                wire_vals[f][g.outs[0].id] = v
            elif k == "bool_message_pass":
                (inw,) = g.ins
                f_in = inw.fid
                f = 1 - f_in
                b = wire_vals[f_in][inw.id]
                slots = self._mp_slots(f)
                assign(
                    f,
                    slots[0].row - 1,
                    w_row=[b, b] + [0] * 14,
                    q_row=[-1, 1, 0, 1] + [0] * 6,
                )
                message_pass_inputs[f].append(b)
                copy[f][g.outs[0].id].append(slots[0])
                wire_vals[f][g.outs[0].id] = b
            elif k in ("scalar_mul_pallas", "scalar_mul_vesta"):
                f = g.ins[0].fid
                m = MODS[f]
                cfg = COORD_CURVE[f]
                if k == "scalar_mul_pallas":
                    h = wire_vals[f][g.ins[0].id]
                    low = wire_vals[f][g.ins[1].id]
                    xg, yg = wire_vals[f][g.ins[2].id], wire_vals[f][g.ins[3].id]
                    nbits = 254
                    assert h < (1 << nbits)
                else:
                    h = wire_vals[f][g.ins[0].id]
                    low = None
                    xg, yg = wire_vals[f][g.ins[1].id], wire_vals[f][g.ins[2].id]
                    nbits = 255
                    assert h < (1 << nbits)
                gpt = (xg, yg)
                # MSB-first bit list; the pallas variant appends the final
                # low-bit row with weight 2^0 (trace_builder.rs:700-727)
                bits = [(h >> i) & 1 for i in range(nbits - 1, -1, -1)]
                pw = 1
                weights = [1] * nbits
                for i in range(1, nbits):
                    pw = pw * 2 % m
                    weights[nbits - 1 - i] = pw
                if k == "scalar_mul_pallas":
                    # a missing low bit is a builder bug; defaulting it to 0
                    # would emit a WRONG witness silently (advisor r4)
                    assert low is not None, "scalar_mul_pallas: low bit unset"
                    bits.append(low)
                    weights.append(1)
                rows_batch = self._scalar_mul_rows_batch(m, cfg, gpt, bits)
                bit_acc = 0
                point_acc = (0, 0)
                for (q_pt, r_pt, beta_q, lam_q, al, ga, de, la), bit, w2i in zip(
                    rows_batch, bits, weights
                ):
                    slots = self._slots(f)
                    assign(
                        f,
                        slots[0].row - 1,
                        w_row=[
                            point_acc[0], point_acc[1], bit_acc, gpt[0], gpt[1],
                            bit, q_pt[0], q_pt[1], r_pt[0], r_pt[1],
                            beta_q, lam_q, al, ga, de, la,
                        ],
                        q_row=[0, 0, 0, 0, 0, 0, 0, 1, 0, 0],
                        r_row=[w2i] + [0] * 14,
                    )
                    point_acc = r_pt if bit else q_pt
                    bit_acc = (bit_acc + bit * w2i) % m
                # zero row exposing the results
                slots = self._slots(f)
                assign(
                    f,
                    slots[0].row - 1,
                    w_row=[point_acc[0], point_acc[1], bit_acc] + [0] * 13,
                    q_row=[0] * 10,
                )
                for wire in g.outs:
                    wire_vals[f][wire.id] = point_acc[wire.out_id]
                # NOTE: the reference does NOT copy-constrain the scalar-mul
                # outputs to the zero row (trace_builder.rs:728-729 only sets
                # the dead wire_output_slots) — sigma parity requires the same
            elif k == "witness_bool":
                (out,) = g.outs
                f = out.fid
                v = self.witnesses[f][out]
                wire_vals[f][out.id] = v
                slots = self._slots(f)
                assign(
                    f,
                    slots[0].row - 1,
                    w_row=[v, v] + [0] * 14,
                    q_row=[-1, 0, 0, 1] + [0] * 6,
                )
                copy[f][out.id].append(slots[0])
            elif k == "eq":
                aw, bw = g.ins
                (out,) = g.outs
                f = out.fid
                m = MODS[f]
                a = wire_vals[f][aw.id]
                b = wire_vals[f][bw.id]
                diff = (a - b) % m
                invv = inv0(m, diff)
                eqv = 1 if a == b else 0
                wire_vals[f][out.id] = eqv
                slots = self._slots(f)
                assign(
                    f,
                    slots[0].row - 1,
                    w_row=[a, b, 1, eqv, invv] + [0] * 11,
                    q_row=[0] * 8 + [1, 0],
                )
                copy[f][aw.id].append(slots[0])
                copy[f][bw.id].append(slots[1])
                copy[f][self.spec.one[f].id].append(slots[2])
                copy[f][out.id].append(slots[3])
            else:
                raise ValueError(f"unknown gate kind {k}")

        for f in (FP, FQ):
            public_inputs[f].extend(message_pass_inputs[f])

        return [
            TraceData(
                fid=f,
                rows=rows[f],
                ws=ws[f],
                rs=rs[f],
                qs=qs[f],
                public_inputs=public_inputs[f],
                message_pass_inputs=message_pass_inputs[f],
                copy_constraints=copy[f],
                outputs=outputs[f],
            )
            for f in (FP, FQ)
        ]

    def _scalar_mul_rows_batch(self, m, cfg, gpt, bits):
        """Witness data for one scalar-mul gate's row chain, computed with
        TWO batched inversion passes instead of ~8 pow(x,-1,m) per row:

          1. the double-and-add chain runs in Jacobian coordinates
             (inversion-free, exact — jac_add/jac_double handle every
             identity/doubling case), then ALL q/r points convert to
             affine through one batch_inv0 of their Z coordinates;
          2. the completeness-helper params (beta, lambda, alpha, ...)
             batch their ~3 denominators per row through a second pass
             (the add-lambda reuses alpha's inverse: same denominator).

        Returns [(q_pt, r_pt, beta_q, lam_q, al, ga, de, la)] per bit;
        values are bit-identical to the sequential affine_add_params /
        affine_double_params path of halo_tpu's arithmetizer."""
        from ..curves import JAC_INF, jac_add, jac_double

        nrows = len(bits)
        xg, yg = gpt
        g_jac = JAC_INF if gpt == (0, 0) else (xg, yg, 1)
        p_jac = JAC_INF
        q_jac = [None] * nrows
        r_jac = [None] * nrows
        for i, bit in enumerate(bits):
            q = jac_double(cfg, p_jac)
            r = jac_add(cfg, q, g_jac)
            q_jac[i] = q
            r_jac[i] = r
            p_jac = r if bit else q

        zinvs = batch_inv0(m, [P[2] for P in q_jac] + [P[2] for P in r_jac])

        def aff(P, zi):
            if P[2] % m == 0:
                return (0, 0)
            zi2 = zi * zi % m
            return (P[0] * zi2 % m, P[1] * zi2 % m * zi % m)

        q_aff = [aff(P, zinvs[i]) for i, P in enumerate(q_jac)]
        r_aff = [aff(P, zinvs[nrows + i]) for i, P in enumerate(r_jac)]
        p_aff = [(0, 0)] + [
            r_aff[i] if bits[i] else q_aff[i] for i in range(nrows - 1)
        ]

        dens = []
        for i in range(nrows):
            xp, yp = p_aff[i]
            dens.append(xp)          # beta_q
            dens.append(2 * yp)      # lam_q (masked when yp == 0)
            dens.append(xg - q_aff[i][0])  # alpha; lam reuses it
        invs = batch_inv0(m, dens)
        ga = inv0(m, xg)  # gamma: constant across the gate's rows

        out = []
        for i in range(nrows):
            xp, yp = p_aff[i]
            xq, yq = q_aff[i]
            beta_q = invs[3 * i]
            lam_q = 3 * xp * xp % m * invs[3 * i + 1] % m if yp != 0 else 0
            al = invs[3 * i + 2]
            if (xg - xq) % m != 0:
                de = 0
                la = (yg - yq) * al % m
            else:
                de = inv0(m, yq + yg)
                la = 3 * xq * xq % m * inv0(m, 2 * yq) % m if yq != 0 else 0
            out.append((q_aff[i], r_aff[i], beta_q, lam_q, al, ga, de, la))
        return out


class TraceData(NamedTuple):
    fid: int
    rows: int
    ws: list
    rs: list
    qs: list
    public_inputs: list
    message_pass_inputs: list
    copy_constraints: list
    outputs: list
