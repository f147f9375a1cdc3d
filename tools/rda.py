"""Minimal reader for R's RDX2 (version-2 XDR) serialization format.

Used once, offline, to export the reference package's example datasets
(/root/reference/data/*.rda -- abalone, heart, wine, student; documented in
reference R/data.R:40-191) into .npz files that this framework loads at
runtime.  Supports only the SEXP types those files use: pairlists, symbols,
character/integer/real/logical vectors, generic vectors (lists), and
attributes (dim, dimnames, names, levels, class).
"""

from __future__ import annotations

import bz2
import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

# SEXP type codes (R internals)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
VECSXP = 19
S4SXP = 25
ALTREP = 238
NILVALUE = 254
REFSXP = 255
NAMESPACESXP = 249
PACKAGESXP = 248
GLOBALENV = 253
UNBOUNDVALUE = 252
MISSINGARG = 251
BASEENV = 250
EMPTYENV = 242

R_NA_INT = -2147483648


@dataclass
class RObj:
    """An R object: data plus attributes."""

    data: object
    attrs: dict = field(default_factory=dict)

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.refs: list = []

    def _take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def u4(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def i4(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def length(self) -> int:
        n = self.i4()
        if n == -1:  # long vector: two 32-bit halves
            hi, lo = self.u4(), self.u4()
            n = (hi << 32) | lo
        return n

    def read_item(self):
        flags = self.u4()
        typ = flags & 255
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if typ in (NILVALUE, NILSXP):
            return None
        if typ == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.u4()
            return self.refs[idx - 1]
        if typ == SYMSXP:
            sym = self.read_item()  # CHARSXP
            self.refs.append(sym)
            return sym
        if typ == CHARSXP:
            n = self.i4()
            if n == -1:
                return None
            return self._take(n).decode("utf-8", errors="replace")
        if typ == LISTSXP:
            # pairlist node
            attrs = self.read_item() if has_attr else None
            tag = self.read_item() if has_tag else None
            car = self.read_item()
            cdr = self.read_item()
            pairs = [(tag, car)]
            if isinstance(cdr, list):
                pairs.extend(cdr)
            elif cdr is not None:
                pairs.append((None, cdr))
            return pairs
        if typ == S4SXP:
            out = RObj(None)
            if has_attr:
                attr_pairs = self.read_item()
                for tag, val in attr_pairs or []:
                    if tag is not None:
                        out.attrs[tag] = val
            return out
        if typ == LGLSXP:
            n = self.length()
            arr = np.frombuffer(self._take(4 * n), dtype=">i4").astype(np.int32)
            out = RObj(arr)
        elif typ == INTSXP:
            n = self.length()
            arr = np.frombuffer(self._take(4 * n), dtype=">i4").astype(np.int32)
            out = RObj(arr)
        elif typ == REALSXP:
            n = self.length()
            arr = np.frombuffer(self._take(8 * n), dtype=">f8").astype(np.float64)
            out = RObj(arr)
        elif typ == STRSXP:
            n = self.length()
            out = RObj([self.read_item() for _ in range(n)])
        elif typ == VECSXP:
            n = self.length()
            out = RObj([self.read_item() for _ in range(n)])
        else:
            raise NotImplementedError(f"SEXP type {typ} not supported")

        if has_attr:
            attr_pairs = self.read_item()
            if attr_pairs:
                for tag, val in attr_pairs:
                    if tag is not None:
                        out.attrs[tag] = val
        return out


def _decompress(path: str) -> bytes:
    raw = open(path, "rb").read()
    if raw[:2] == b"BZ":
        return bz2.decompress(raw)
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:4] == b"\xfd7zX":
        import lzma

        return lzma.decompress(raw)
    return raw


def load_rda(path: str) -> dict:
    """Load an .rda file; returns {name: RObj}."""
    buf = _decompress(path)
    assert buf[:5] == b"RDX2\n", f"not an RDX2 file: {buf[:8]!r}"
    assert buf[5:7] == b"X\n", "only XDR format supported"
    r = _Reader(buf)
    r.pos = 7
    _version = r.u4()
    _writer = r.u4()
    _reader_min = r.u4()
    top = r.read_item()
    out = {}
    for tag, val in top or []:
        if tag is not None:
            out[tag] = val
    return out


def to_matrix(obj: RObj) -> np.ndarray:
    """Convert an R numeric matrix (column-major with dim attr) to 2-D numpy."""
    dim = obj.attr("dim")
    arr = np.asarray(obj.data, dtype=np.float64)
    if dim is not None:
        d = np.asarray(dim.data, dtype=int)
        arr = arr.reshape(tuple(d[::-1])).T if len(d) == 2 else arr.reshape(tuple(d), order="F")
    return arr


def factor_to_labels(obj: RObj) -> np.ndarray:
    """Convert an R factor to an array of string labels."""
    levels = obj.attr("levels")
    codes = np.asarray(obj.data, dtype=int)
    labels = np.asarray([levels.data[c - 1] for c in codes])
    return labels
