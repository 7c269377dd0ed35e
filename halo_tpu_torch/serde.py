"""The proof byte format (the port's copy of halo_tpu/serde.py: Reader and
Writer).

arkworks' CanonicalSerialize, the subset proofs use: a field element is 32
LE bytes, canonical; a point is compressed, x as 32 LE bytes with the flags
in the two top bits of a 33rd byte (bit 7 = y is negative, i.e. y > p - y;
bit 6 = infinity, which writes x = 0); u64 is 8 LE bytes; Vec<T> is a u64
length then the items; Option<T> is a u8 tag then the item.

Reader refuses what Writer would never write, with a SerdeError (an
exception, not an assert, so that `python -O` keeps the checks): an early
end, a field element or abscissa >= the modulus, an option tag other than
0 or 1, both flag bits set, infinity with x != 0, an x off the curve.
Serde gives a class with serialize/deserialize its to_bytes/from_bytes.
"""

from __future__ import annotations

from .curves import Affine, CurveCfg, decompress_point
from .errors import SerdeError


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bytes(self, n: int) -> bytes:
        out = self.data[self.pos: self.pos + n]
        if len(out) != n:
            raise SerdeError(f"unexpected end of data at byte {self.pos} (wanted {n} more)")
        self.pos += n
        return out

    def u8(self) -> int:
        return self.bytes(1)[0]

    def u64(self) -> int:
        return int.from_bytes(self.bytes(8), "little")

    def field(self, m: int) -> int:
        v = int.from_bytes(self.bytes(32), "little")
        if v >= m:
            raise SerdeError(f"non-canonical field element at byte {self.pos - 32}")
        return v

    def point_compressed(self, cfg: CurveCfg) -> Affine:
        raw = bytearray(self.bytes(33))
        flags = raw[32] >> 6
        raw[32] &= 0x3F
        x = int.from_bytes(bytes(raw), "little")
        at = self.pos - 33
        if flags == 0b11:
            raise SerdeError(f"point at byte {at}: both flag bits set")
        if flags & 0b01:  # bit 6 = infinity
            if x != 0:
                raise SerdeError(f"point at byte {at}: infinity with x != 0")
            return None
        if x >= cfg.p:
            raise SerdeError(f"point at byte {at}: non-canonical x")
        try:
            return decompress_point(cfg, x, y_is_negative=bool(flags & 0b10))  # bit 7
        except ValueError as e:
            raise SerdeError(f"point at byte {at}: {e}") from e

    def option(self, parse):
        tag = self.u8()
        if tag == 0:
            return None
        if tag != 1:
            raise SerdeError(f"option tag {tag} at byte {self.pos - 1}")
        return parse()

    def vec(self, parse) -> list:
        return [parse() for _ in range(self.u64())]

    def done(self) -> bool:
        return self.pos == len(self.data)


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


class Serde:
    """to_bytes/from_bytes for a class with serialize(w, cfg) and
    deserialize(r, cfg)."""

    def to_bytes(self, cfg: CurveCfg) -> bytes:
        w = Writer()
        self.serialize(w, cfg)
        return w.data()

    @classmethod
    def from_bytes(cls, data: bytes, cfg: CurveCfg):
        """Parse; raises SerdeError on malformed or trailing bytes."""
        r = Reader(data)
        out = cls.deserialize(r, cfg)
        if not r.done():
            raise SerdeError(f"{len(data) - r.pos} trailing bytes after the {cls.__name__}")
        return out
