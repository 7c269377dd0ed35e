"""The proof byte format (the port's copy of halo_tpu/serde.py's Writer).

arkworks' CanonicalSerialize, the subset proofs use: a field element is 32
LE bytes, canonical; a point is compressed, x as 32 LE bytes with the flags
in the two top bits of a 33rd byte (bit 7 = y is negative, i.e. y > p - y;
bit 6 = infinity, which writes x = 0); u64 is 8 LE bytes; Vec<T> is a u64
length then the items; Option<T> is a u8 tag then the item.
"""

from __future__ import annotations

from .curves import Affine, CurveCfg


class Writer:
    def __init__(self):
        self.out = bytearray()

    def u8(self, v: int) -> None:
        self.out.append(v)

    def u64(self, v: int) -> None:
        self.out += v.to_bytes(8, "little")

    def field(self, v: int) -> None:
        self.out += v.to_bytes(32, "little")

    def point_compressed(self, cfg: CurveCfg, pt: Affine) -> None:
        if pt is None:
            raw = bytearray(33)
            raw[32] |= 0x40  # bit6 = infinity
            self.out += raw
            return
        x, y = pt
        raw = bytearray(x.to_bytes(33, "little"))
        if y > cfg.p - y:
            raw[32] |= 0x80  # bit7 = negative y
        self.out += raw

    def option(self, v, write) -> None:
        if v is None:
            self.u8(0)
        else:
            self.u8(1)
            write(v)

    def vec(self, items, write) -> None:
        self.u64(len(items))
        for it in items:
            write(it)

    def data(self) -> bytes:
        return bytes(self.out)
