"""A minimal pure-NumPy HDF5 reader/writer for machines without h5py.

The sim folder is a set of HDF5 files of plain numeric datasets in the root
group (io/h5.py).  When h5py is not installed, `File` here stands in for
`h5py.File` on exactly that subset:

- writes: numeric arrays and scalars (integer, unsigned, float, bool as
  uint8), contiguous storage, no compression, in a superblock-v2 file
  with a compact ("new-style") root group — a valid HDF5 file that h5py
  and the reference's C loader read like any other;
- reads: files this module wrote.  Files written by libhdf5 itself (for
  instance the reference's own sim folders) use structures this reader
  does not parse; it refuses them with an error that says to install
  h5py.

Modes "r", "w" and "r+"; the whole file is held in memory and written
back on close ("w", "r+").  Format reference: the HDF5 File Format
Specification, version 3.0 (superblock v2, object header v2, Link Info,
Group Info, Link, Dataspace v2, Datatype v1, Fill Value v3 and Data
Layout v3 messages).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL, _LINK, _LAYOUT, _GROUP_INFO = \
    0x01, 0x02, 0x03, 0x05, 0x06, 0x08, 0x0A


def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 hashlittle(), the HDF5 metadata checksum."""
    M = 0xFFFFFFFF
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & M
    i = 0
    while n - i > 12:
        a = (a + int.from_bytes(data[i:i + 4], "little")) & M
        b = (b + int.from_bytes(data[i + 4:i + 8], "little")) & M
        c = (c + int.from_bytes(data[i + 8:i + 12], "little")) & M
        a = ((a - c) & M) ^ _rot(c, 4); c = (c + b) & M
        b = ((b - a) & M) ^ _rot(a, 6); a = (a + c) & M
        c = ((c - b) & M) ^ _rot(b, 8); b = (b + a) & M
        a = ((a - c) & M) ^ _rot(c, 16); c = (c + b) & M
        b = ((b - a) & M) ^ _rot(a, 19); a = (a + c) & M
        c = ((c - b) & M) ^ _rot(b, 4); b = (b + a) & M
        i += 12
    if n - i == 0:
        return c
    tail = data[i:] + bytes(12 - (n - i))
    a = (a + int.from_bytes(tail[0:4], "little")) & M
    b = (b + int.from_bytes(tail[4:8], "little")) & M
    c = (c + int.from_bytes(tail[8:12], "little")) & M
    c ^= b; c = (c - _rot(b, 14)) & M
    a ^= c; a = (a - _rot(c, 11)) & M
    b ^= a; b = (b - _rot(a, 25)) & M
    c ^= b; c = (c - _rot(b, 16)) & M
    a ^= c; a = (a - _rot(c, 4)) & M
    b ^= a; b = (b - _rot(a, 14)) & M
    c ^= b; c = (c - _rot(b, 24)) & M
    return c


# ------------------------------------------------------------------ encode
def _msg(mtype: int, body: bytes) -> bytes:
    return struct.pack("<BHB", mtype, len(body), 0) + body


def _ohdr(messages: bytes) -> bytes:
    """Version-2 object header (4-byte chunk size, no times), checksummed."""
    head = b"OHDR" + struct.pack("<BBI", 2, 2, len(messages)) + messages
    return head + struct.pack("<I", lookup3(head))


def _storable(data) -> np.ndarray:
    a = np.asarray(data)
    if a.dtype == np.bool_:
        a = a.astype(np.uint8)
    if a.dtype.kind not in "iuf":
        raise TypeError(f"hdf5_lite stores numeric data only, got {a.dtype}")
    # (np.ascontiguousarray would promote a scalar to shape (1,))
    return np.require(a.astype(a.dtype.newbyteorder("<"), copy=False),
                      requirements="C")


def _datatype(dt: np.dtype) -> bytes:
    size = dt.itemsize
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0x00
        return (struct.pack("<B3BI", 0x10, bits, 0, 0, size)
                + struct.pack("<HH", 0, 8 * size))
    exp, mant, bias = {4: (8, 23, 127), 8: (11, 52, 1023)}[size]
    return (struct.pack("<B3BI", 0x11, 0x20, 8 * size - 1, 0, size)
            + struct.pack("<HHBBBBI", 0, 8 * size, mant, exp, 0, mant, bias))


def _dataset_header(a: np.ndarray, addr: int) -> bytes:
    dims = b"".join(struct.pack("<Q", d) for d in a.shape)
    space = struct.pack("<BBBB", 2, a.ndim, 0, 1 if a.ndim else 0) + dims
    fill = struct.pack("<BB", 3, 0x0A)   # late allocation, fill if set
    layout = struct.pack("<BBQQ", 3, 1, addr if a.nbytes else UNDEF,
                         a.nbytes)
    return _ohdr(_msg(_DATASPACE, space) + _msg(_DATATYPE, _datatype(a.dtype))
                 + _msg(_FILL, fill) + _msg(_LAYOUT, layout))


def _group_header(links: dict) -> bytes:
    body = _msg(_LINK_INFO, struct.pack("<BBQQ", 0, 0, UNDEF, UNDEF))
    body += _msg(_GROUP_INFO, struct.pack("<BB", 0, 0))
    for name, addr in links.items():
        nb = name.encode()
        if not 0 < len(nb) < 256:
            raise ValueError(f"dataset name length out of range: {name!r}")
        body += _msg(_LINK, struct.pack("<BBB", 1, 0, len(nb)) + nb
                     + struct.pack("<Q", addr))
    return _ohdr(body)


def write(path, datasets: dict) -> None:
    """Write {name: array} as root-group datasets of a new HDF5 file."""
    arrays = {k: _storable(v) for k, v in datasets.items()}
    root_at = 48
    addr = root_at + len(_group_header({k: 0 for k in arrays}))
    hdr_at = {}
    for k, a in arrays.items():
        hdr_at[k] = addr
        addr += len(_dataset_header(a, 0))
    data_at = {}
    for k, a in arrays.items():
        addr = -(-addr // 8) * 8
        data_at[k] = addr
        addr += a.nbytes
    eof = addr

    sb = SIGNATURE + struct.pack("<BBBB", 2, 8, 8, 0) + struct.pack(
        "<QQQQ", 0, UNDEF, eof, root_at)
    sb += struct.pack("<I", lookup3(sb))
    buf = bytearray(eof)
    buf[:48] = sb
    root = _group_header(hdr_at)
    buf[root_at:root_at + len(root)] = root
    for k, a in arrays.items():
        h = _dataset_header(a, data_at[k])
        buf[hdr_at[k]:hdr_at[k] + len(h)] = h
        buf[data_at[k]:data_at[k] + a.nbytes] = a.tobytes()
    Path(path).write_bytes(bytes(buf))


# ------------------------------------------------------------------ decode
class FormatError(ValueError):
    pass


def _messages(buf: bytes, at: int):
    if buf[at:at + 4] != b"OHDR" or buf[at + 4] != 2:
        raise FormatError("not a version-2 object header")
    flags = buf[at + 5]
    p = at + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    nsz = 1 << (flags & 3)
    size = int.from_bytes(buf[p:p + nsz], "little")
    p += nsz
    end = p + size
    if struct.unpack_from("<I", buf, end)[0] != lookup3(buf[at:end]):
        raise FormatError("object header checksum mismatch")
    while p + 4 <= end:
        mtype, msize, mflags = struct.unpack_from("<BHB", buf, p)
        p += 4 + (2 if flags & 0x04 else 0)
        yield mtype, buf[p:p + msize]
        p += msize


def _decode_dtype(m: bytes) -> np.dtype:
    cls, size = m[0] & 0x0F, struct.unpack_from("<I", m, 4)[0]
    if m[1] & 0x01:
        raise FormatError("big-endian data")
    if cls == 0:
        return np.dtype(f"<{'i' if m[1] & 0x08 else 'u'}{size}")
    if cls == 1 and size in (4, 8):
        return np.dtype(f"<f{size}")
    raise FormatError(f"datatype class {cls} (size {size})")


def read(path) -> dict:
    """{name: array} of a file written by `write` (scalars as 0-d arrays)."""
    buf = Path(path).read_bytes()
    if buf[:8] != SIGNATURE:
        raise FormatError(f"{path}: not an HDF5 file")
    if buf[8] not in (2, 3):
        raise FormatError(f"{path}: superblock version {buf[8]} (written by "
                          "libhdf5): install h5py to read it")
    if struct.unpack_from("<I", buf, 44)[0] != lookup3(buf[:44]):
        raise FormatError(f"{path}: superblock checksum mismatch")
    root = struct.unpack_from("<Q", buf, 36)[0]
    out = {}
    try:
        for mtype, m in _messages(buf, root):
            if mtype != _LINK:
                continue
            if m[0] != 1 or m[1] & ~0x03:
                raise FormatError("unsupported link message")
            nsz = 1 << (m[1] & 3)
            n = int.from_bytes(m[2:2 + nsz], "little")
            name = m[2 + nsz:2 + nsz + n].decode()
            out[name] = _read_dataset(buf, struct.unpack_from(
                "<Q", m, 2 + nsz + n)[0])
    except FormatError as e:
        raise FormatError(f"{path}: {e} (install h5py to read files "
                          "written by libhdf5)") from None
    return out


def _read_dataset(buf: bytes, at: int) -> np.ndarray:
    shape = dtype = layout = None
    for mtype, m in _messages(buf, at):
        if mtype == _DATASPACE:
            if m[0] != 2:
                raise FormatError("dataspace version")
            shape = struct.unpack_from(f"<{m[1]}Q", m, 4)
        elif mtype == _DATATYPE:
            dtype = _decode_dtype(m)
        elif mtype == _LAYOUT:
            if m[0] != 3 or m[1] != 1:
                raise FormatError("only contiguous storage is supported")
            layout = struct.unpack_from("<QQ", m, 2)
    if shape is None or dtype is None or layout is None:
        raise FormatError("incomplete dataset header")
    addr, nbytes = layout
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != nbytes:
        raise FormatError("dataset size mismatch")
    if not nbytes:
        return np.zeros(shape, dtype)
    return np.frombuffer(buf, dtype, count, addr).reshape(shape).copy()


# ------------------------------------------------------- h5py-like facade
class Dataset:
    def __init__(self, f: "File", name: str):
        self._f, self._name = f, name

    def __getitem__(self, key):
        a = self._f._data[self._name]
        return a[()] if a.ndim == 0 and key in ((), Ellipsis) else a[key]

    def __setitem__(self, key, value):
        if self._f.mode == "r":
            raise OSError("file is read-only")
        a = self._f._data[self._name].copy()
        a[key] = value
        self._f._data[self._name] = a


class File:
    """Stand-in for `h5py.File` over root-group numeric datasets."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "r+", "w"):
            raise ValueError(f"mode {mode!r}")
        self.path, self.mode = Path(path), mode
        self._data = {} if mode == "w" else read(self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self.mode != "r" and self._data is not None:
            write(self.path, self._data)
        self._data = None

    def __contains__(self, name):
        return name in self._data

    def __getitem__(self, name):
        if name not in self._data:
            raise KeyError(name)
        return Dataset(self, name)

    def __delitem__(self, name):
        del self._data[name]

    def create_dataset(self, name, data, **storage):
        """storage options (compression, ...) are accepted and ignored:
        everything is stored contiguous and uncompressed."""
        if self.mode == "r":
            raise OSError("file is read-only")
        if name in self._data:
            raise ValueError(f"dataset {name!r} exists")
        self._data[name] = _storable(data)
        return Dataset(self, name)
