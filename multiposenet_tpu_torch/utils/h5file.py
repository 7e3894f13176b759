"""The HDF5 files of the reference's checkpoints, read and written with
numpy alone, so that the port needs no ``h5py`` (GPU hosts often lack
it).

The reference writes a checkpoint as one HDF5 file whose root group holds
one dataset per ``state_dict`` key and an ``epoch`` attribute (reference
network/net_utils.py:30-66, through h5py's defaults).  This module covers
that layout and no more, in the HDF5 file format's original structures,
which h5py writes by default (HDF5 File Format Specification, version 2):

- superblock version 0 or 1, 8-byte offsets and lengths;
- the root group as a symbol table: a version 1 B-tree (any depth) over
  symbol-table nodes, names in a local heap;
- version 1 object headers, with continuation blocks;
- datasets of fixed-point or IEEE floating-point numbers of either byte
  order, scalar or of any rank (version 1 dataspaces), stored contiguous
  and unfiltered (version 3 layout messages);
- version 1 attributes of the same types.

Anything else (groups below the root, chunked, compact or compressed
storage, version 2 object headers, other superblocks) raises ``H5Error``
naming it.
The writer emits a file h5py reads: superblock 0, one symbol-table node
sized to hold every name, and the datasets contiguous.
"""

from __future__ import annotations

import struct
from typing import Dict, Mapping, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_ENTRY = 40                  # a symbol table entry with 8-byte offsets


class H5Error(ValueError):
    pass


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------- reading

class _Reader:
    def __init__(self, buf: bytes, path: str):
        self.buf = buf
        self.path = path
        self.base = 0

    def fail(self, what: str):
        raise H5Error(f"{self.path}: {what}")

    def u(self, off: int, n: int) -> int:
        return int.from_bytes(self.buf[off: off + n], "little")

    def superblock(self) -> int:
        """The root group's object header address."""
        for off in (0, 512, 1024, 2048, 4096, 8192):
            if self.buf[off: off + 8] == _SIGNATURE:
                break
        else:
            self.fail("not an HDF5 file")
        version = self.buf[off + 8]
        if version not in (0, 1):
            self.fail(f"superblock version {version} (only 0 and 1 are read)")
        if self.buf[off + 13] != 8 or self.buf[off + 14] != 8:
            self.fail("offsets or lengths not 8 bytes")
        self.base = self.u(off + 24, 8)
        root = off + (56 if version == 0 else 60)
        return self.base + self.u(root + 8, 8)

    def messages(self, addr: int):
        """(type, data offset, size) of every message of a version 1
        object header, continuation blocks included."""
        if self.buf[addr: addr + 4] == b"OHDR":
            self.fail("version 2 object headers are not read")
        if self.buf[addr] != 1:
            self.fail(f"object header version {self.buf[addr]} at {addr}")
        count = self.u(addr + 2, 2)
        blocks = [(addr + 16, self.u(addr + 8, 4))]
        out = []
        while blocks and len(out) < count:
            start, size = blocks.pop(0)
            off = start
            while off + 8 <= start + size and len(out) < count:
                mtype, msize = self.u(off, 2), self.u(off + 2, 2)
                data = off + 8
                if mtype == 0x10:        # continuation
                    blocks.append((self.base + self.u(data, 8), self.u(data + 8, 8)))
                out.append((mtype, data, msize))
                off = data + msize
        return out

    def dtype(self, off: int) -> np.dtype:
        """A datatype message -> its numpy dtype."""
        cls, bits, size = self.buf[off] & 0x0F, self.buf[off + 1], self.u(off + 4, 4)
        order = ">" if bits & 1 else "<"
        if cls == 0 and size in (1, 2, 4, 8):
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1 and size in (2, 4, 8) and not bits & 0x40:
            return np.dtype(f"{order}f{size}")
        self.fail(f"datatype class {cls} of {size} bytes")

    def dataspace(self, off: int) -> tuple:
        """A version 1 dataspace message -> its shape (() for a scalar)."""
        version, rank = self.buf[off], self.buf[off + 1]
        if version != 1:
            self.fail(f"dataspace version {version}")
        return tuple(self.u(off + 8 + 8 * i, 8) for i in range(rank))

    def raw(self, dt: np.dtype, shape: tuple, data: bytes) -> np.ndarray:
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if len(data) < n:
            self.fail("data shorter than its dataspace")
        return np.frombuffer(data[:n], dt).reshape(shape).astype(dt.newbyteorder("="))

    def dataset(self, addr: int, name: str) -> np.ndarray:
        dt = shape = layout = None
        for mtype, off, _ in self.messages(addr):
            if mtype == 0x01:
                shape = self.dataspace(off)
            elif mtype == 0x03:
                dt = self.dtype(off)
            elif mtype == 0x08:
                layout = off
            elif mtype == 0x0B:
                self.fail(f"{name}: filtered (compressed) data is not read")
        if dt is None or shape is None or layout is None:
            self.fail(f"{name}: not a dataset")
        if self.buf[layout] != 3 or self.buf[layout + 1] != 1:
            self.fail(f"{name}: chunked, compact or older-format storage "
                      "is not read")
        where = self.base + self.u(layout + 2, 8)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        return self.raw(dt, shape, self.buf[where: where + n])

    def attribute(self, off: int) -> Tuple[str, np.ndarray]:
        """A version 1 attribute message -> (name, value)."""
        if self.buf[off] != 1:
            self.fail(f"attribute message version {self.buf[off]}")
        nlen, tlen, slen = self.u(off + 2, 2), self.u(off + 4, 2), self.u(off + 6, 2)
        name = off + 8
        dtype = name + _pad8(nlen)
        space = dtype + _pad8(tlen)
        data = space + _pad8(slen)
        return (self.buf[name: name + nlen].rstrip(b"\0").decode(),
                self.raw(self.dtype(dtype), self.dataspace(space), self.buf[data:]))

    def group_entries(self, btree: int, heap: int):
        """(name, object header address) of every link of a symbol-table
        group, in the B-tree's order."""
        if self.buf[heap: heap + 4] != b"HEAP":
            self.fail("no local heap")
        names = self.base + self.u(heap + 24, 8)

        def name_at(off: int) -> str:
            end = self.buf.index(b"\0", names + off)
            return self.buf[names + off: end].decode()

        out = []
        stack = [btree]
        while stack:
            node = stack.pop(0)
            if self.buf[node: node + 4] != b"TREE" or self.buf[node + 4] != 0:
                self.fail("not a group B-tree node")
            level, used = self.buf[node + 5], self.u(node + 6, 2)
            children = [self.base + self.u(node + 24 + 8 + 16 * i, 8)
                        for i in range(used)]
            if level:
                stack[0:0] = children
                continue
            for snod in children:
                if self.buf[snod: snod + 4] != b"SNOD":
                    self.fail("not a symbol table node")
                for i in range(self.u(snod + 6, 2)):
                    e = snod + 8 + _ENTRY * i
                    out.append((name_at(self.u(e, 8)), self.base + self.u(e + 8, 8)))
        return out


def read_h5(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The datasets and attributes of an HDF5 file's root group:
    ({name: array}, {name: array}).  Raises ``H5Error`` on a layout this
    module does not read (a group below the root among them)."""
    with open(path, "rb") as f:
        r = _Reader(f.read(), path)
    root = r.superblock()
    table, attrs = None, {}
    for mtype, off, _ in r.messages(root):
        if mtype == 0x11:
            table = (r.base + r.u(off, 8), r.base + r.u(off + 8, 8))
        elif mtype == 0x0C:
            name, value = r.attribute(off)
            attrs[name] = value
        elif mtype in (0x02, 0x06, 0x0A):
            r.fail("the root group is not a symbol-table group")
    if table is None:
        r.fail("the root group has no symbol table")
    data = {}
    for name, addr in r.group_entries(*table):
        if any(t == 0x11 for t, _, _ in r.messages(addr)):
            r.fail(f"{name}: groups below the root are not read")
        data[name] = r.dataset(addr, name)
    return data, attrs


# ---------------------------------------------------------------- writing

def _datatype(dt: np.dtype) -> bytes:
    dt = np.dtype(dt).newbyteorder("<")
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HH", 0, 8 * dt.itemsize))
    if dt.kind == "f" and dt.itemsize in (4, 8):
        exp, mant, bias = (8, 23, 127) if dt.itemsize == 4 else (11, 52, 1023)
        sign = 8 * dt.itemsize - 1
        return (bytes([0x11, 0x20, sign, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, mant, exp, 0, mant,
                              bias))
    raise H5Error(f"dtype {dt} is not written")


def _dataspace(shape: tuple) -> bytes:
    return bytes([1, len(shape), 0, 0, 0, 0, 0, 0]) + b"".join(
        struct.pack("<Q", d) for d in shape)


def _message(mtype: int, data: bytes) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


def _object_header(messages: bytes, count: int) -> bytes:
    return struct.pack("<BBHII4x", 1, 0, count, 1, len(messages)) + messages


def write_h5(path: str, datasets: Mapping[str, np.ndarray],
             attrs: Mapping[str, int] = ()) -> None:
    """An HDF5 file whose root group holds ``datasets`` (contiguous, little
    endian, numpy arrays of integers or float32/float64) and integer
    scalar ``attrs``, in the layout h5py writes by default."""
    names = sorted(datasets, key=lambda n: n.encode())
    if any(not n or "/" in n for n in names):
        raise H5Error("dataset names must be non-empty and hold no '/'")
    leaf_k = max(4, (len(names) + 1) // 2)       # one node holds every name
    internal_k = 16

    # local heap: "" at offset 0, then each name, each padded to 8
    heap_data, offsets = bytearray(8), {}
    for n in names:
        offsets[n] = len(heap_data)
        b = n.encode() + b"\0"
        heap_data += b + b"\0" * (_pad8(len(b)) - len(b))

    attr_msgs = b""
    for k, v in dict(attrs).items():
        name = k.encode() + b"\0"
        dtype, space = _datatype(np.dtype("<i8")), _dataspace(())
        body = (struct.pack("<BBHHH", 1, 0, len(name), len(dtype), len(space))
                + name + b"\0" * (_pad8(len(name)) - len(name))
                + dtype + b"\0" * (_pad8(len(dtype)) - len(dtype))
                + space + struct.pack("<q", int(v)))
        attr_msgs += _message(0x0C, body)

    # layout: superblock, root header, heap, B-tree, symbol node, datasets
    sb_size = 96
    root_size = 16 + 24 + len(attr_msgs)
    heap_at = sb_size + root_size
    heap_data_at = heap_at + 32
    btree_at = heap_data_at + len(heap_data)
    btree_size = 24 + (2 * internal_k + 1) * 8 + 2 * internal_k * 8
    snod_at = btree_at + btree_size
    at = snod_at + 8 + 2 * leaf_k * _ENTRY

    headers, blobs, entries = [], [], []
    for n in names:
        a = np.asarray(datasets[n])
        raw = a.astype(a.dtype.newbyteorder("<")).tobytes()   # C order
        hdr_at = at
        hdr_len = 16 + 8 * 4 + _pad8(len(_dataspace(a.shape))) + _pad8(
            len(_datatype(a.dtype))) + 8 + 24
        data_at = hdr_at + hdr_len
        msgs = (_message(0x01, _dataspace(a.shape))
                + _message(0x03, _datatype(a.dtype))
                + _message(0x05, bytes([2, 2, 2, 0]))
                + _message(0x08, struct.pack("<BBQQ", 3, 1, data_at, len(raw))))
        header = _object_header(msgs, 4)
        assert len(header) == hdr_len
        headers.append((hdr_at, header))
        blobs.append((data_at, raw))
        entries.append(struct.pack("<QQII16x", offsets[n], hdr_at, 0, 0))
        at = _pad8(data_at + len(raw))
    eof = at

    out = bytearray(eof)
    out[0:sb_size] = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                      + struct.pack("<HHI", leaf_k, internal_k, 0)
                      + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
                      + struct.pack("<QQII", 0, sb_size, 1, 0)
                      + struct.pack("<QQ", btree_at, heap_at))
    out[sb_size: heap_at] = _object_header(
        _message(0x11, struct.pack("<QQ", btree_at, heap_at)) + attr_msgs,
        1 + len(dict(attrs)))
    out[heap_at: heap_data_at] = (b"HEAP" + bytes([0, 0, 0, 0])
                                  + struct.pack("<QQQ", len(heap_data), 1,
                                                heap_data_at))
    out[heap_data_at: btree_at] = heap_data
    last = offsets[names[-1]] if names else 0
    node = (b"TREE" + bytes([0, 0]) + struct.pack("<H", 1 if names else 0)
            + struct.pack("<QQ", _UNDEF, _UNDEF)
            + struct.pack("<QQQ", 0, snod_at, last))
    out[btree_at: btree_at + len(node)] = node
    snod = b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(names)) + b"".join(entries)
    out[snod_at: snod_at + len(snod)] = snod
    for where, blob in headers + blobs:
        out[where: where + len(blob)] = blob
    with open(path, "wb") as f:
        f.write(out)
