"""Pluggable object I/O, the analog of the reference's ioctx vtable.

Reference parity (include/io.h:7-16, lib/io.c): three backends — stdio file,
in-memory buffer, mmap — behind seek/read/write/size.  Here the interface is
positional (read_at/write_at) which maps directly onto the codec's
symbol-range scatter/gather (codec.partition.symbol_ranges) and avoids
stateful seek bookkeeping.  The mmap backend grows files on demand for
writers like the reference's ftruncate path (lib/io.c:258-300).
"""

import mmap
import os

import numpy as np
import torch


def _runs(offsets: np.ndarray, L: int):
    """(order, sorted offsets, [start, end) pairs): the offsets sorted, cut
    into runs of adjacent rows of L bytes."""
    order = np.argsort(offsets, kind="stable")
    offs = offsets[order]
    brk = np.nonzero(np.diff(offs) != L)[0] + 1
    return order, offs, zip(np.r_[0, brk], np.r_[brk, offs.size])


def read_rows(io, offsets, out) -> None:
    """Read rows of out's length at the given byte offsets of io into out [n,
    L], which may be a strided view (the column band of one block in an
    object's matrix).  Callers must pre-clamp rows that would run past the
    object size, as for write_rows_at (the codec does: _read_symbols_into
    reads the final short symbol apart).  Where io has a `buffer` (MemoryIO)
    and the offsets rise by L (the N=1 symbol layout), the rows are one slice
    of it, copied in one torch copy with no temporary (torch splits a large
    copy over its intra-op threads; a read-only or reversed buffer, which
    torch does not wrap, in one numpy copy).  Otherwise adjacent offsets are
    merged into runs, each read with one read_at and one assignment (an
    in-order block is one read)."""
    offsets = np.asarray(offsets, np.int64)
    n, L = out.shape
    if not n:
        return
    buf = getattr(io, "buffer", None)
    if buf is not None and np.all(np.diff(offsets) == L):
        r0 = int(offsets[0])
        src = buf[r0 : r0 + n * L].reshape(n, L)
        if src.flags.writeable and min(src.strides) >= 0:
            torch.from_numpy(out).copy_(torch.from_numpy(src))
        else:
            out[:] = src
        return
    order, offs, runs = _runs(offsets, L)
    for s, e in runs:
        out[order[s:e]] = np.frombuffer(io.read_at(int(offs[s]), int(e - s) * L), np.uint8).reshape(-1, L)


class IOContext:
    """Positional byte I/O over an object of known (or growable) size."""

    writable = False
    seekable = True

    def read_at(self, offset: int, n: int) -> bytes:
        raise NotImplementedError

    def write_at(self, offset: int, data) -> int:
        raise NotImplementedError

    def write_rows_at(self, offsets, rows) -> None:
        """Write uniform-length rows at the given byte offsets.  Callers
        must pre-clamp tail rows that would run past the object size (the
        codec does: _write_symbols_coalesced truncates the final short
        symbol before calling here).  Default: sort by offset and merge
        adjacent rows into single write_at calls (an in-order burst
        collapses to one write).  Subclasses with random-access buffers
        override with a vectorized scatter."""
        offsets = np.asarray(offsets, np.int64)
        rows = np.asarray(rows, np.uint8)
        if rows.ndim == 1:
            rows = rows[None]
        order, offs, runs = _runs(offsets, rows.shape[1])
        for s, e in runs:
            self.write_at(int(offs[s]), rows[order[s:e]].reshape(-1))

    def read_rows_at(self, offsets, out) -> None:
        """Read rows of out's length at the given byte offsets into out [n,
        L]: `read_rows`, the mirror of write_rows_at."""
        read_rows(self, offsets, out)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MemoryIO(IOContext):
    """Zero-copy view over a bytearray / NumPy uint8 buffer (io.c:139-157).

    ``writable`` reflects the wrapped buffer's mutability: ``bytes`` (and
    read-only views/arrays) yield a read-only context whose write_at raises.
    """

    def __init__(self, buf):
        if isinstance(buf, (bytes, bytearray, memoryview)):
            self._buf = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, bytes) else np.asarray(
                memoryview(buf), dtype=np.uint8
            )
        else:
            self._buf = np.asarray(buf, dtype=np.uint8)
        self.writable = bool(self._buf.flags.writeable)

    @property
    def buffer(self) -> np.ndarray:
        return self._buf

    def read_at(self, offset: int, n: int) -> bytes:
        return self._buf[offset : offset + n].tobytes()

    def read_view(self, offset: int, n: int) -> np.ndarray:
        return self._buf[offset : offset + n]

    def write_at(self, offset: int, data) -> int:
        if not self.writable:
            raise IOError("MemoryIO wraps a read-only buffer (pass a bytearray or writable array to decode into)")
        d = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8)
        n = min(len(d), len(self._buf) - offset)
        self._buf[offset : offset + n] = d[:n]
        return n

    def write_rows_at(self, offsets, rows) -> None:
        """Vectorized scatter: T-strided offsets (the N=1 symbol layout)
        land as ONE fancy-index assignment into a [*, T] view of the
        buffer; anything else falls back to the run-merging default."""
        if not self.writable:
            raise IOError("MemoryIO wraps a read-only buffer (pass a bytearray or writable array to decode into)")
        offsets = np.asarray(offsets, np.int64)
        rows = np.asarray(rows, np.uint8)
        if rows.ndim == 1:
            rows = rows[None]
        T = rows.shape[1]
        end = len(self._buf)
        full = offsets + T <= end
        offs = offsets[full]
        if offs.size:
            r0 = int(offs.min())
            if np.all((offs - r0) % T == 0):
                span = int(offs.max()) - r0 + T
                self._buf[r0 : r0 + span].reshape(-1, T)[(offs - r0) // T] = rows[full]
            else:
                super().write_rows_at(offs, rows[full])
        for i in np.nonzero(~full)[0]:  # clamped tail rows (final short symbol)
            self.write_at(int(offsets[i]), rows[i])

    def size(self) -> int:
        return len(self._buf)


class FileIO(IOContext):
    """Buffered file-descriptor I/O (io.c:54-80)."""

    def __init__(self, path: str, write: bool = False, create_size: int | None = None):
        mode = "r+b" if write and os.path.exists(path) else ("w+b" if write else "rb")
        self._f = open(path, mode)
        self.writable = write
        if create_size:
            self._f.truncate(create_size)

    def read_at(self, offset: int, n: int) -> bytes:
        self._f.seek(offset)
        return self._f.read(n)

    def write_at(self, offset: int, data) -> int:
        self._f.seek(offset)
        return self._f.write(bytes(data) if not isinstance(data, (bytes, bytearray)) else data)

    def size(self) -> int:
        pos = self._f.tell()
        self._f.seek(0, os.SEEK_END)
        n = self._f.tell()
        self._f.seek(pos)
        return n

    def close(self) -> None:
        self._f.close()


class MmapIO(IOContext):
    """Memory-mapped file I/O with on-demand growth for writers
    (io.c:159-388).

    By default the whole file is mapped (the kernel's page cache does the
    windowing on 64-bit hosts).  Pass ``window`` (bytes, page-aligned up)
    for the reference's sliding-window behavior (lib/io.c:159-236): only a
    bounded VA range is mapped at a time and accesses outside it remap —
    this bounds address-space usage toward the format's 881 GB maximum
    object, and on 32-bit-ish VA budgets it is the only way to touch such
    objects at all."""

    def __init__(self, path: str, write: bool = False, create_size: int | None = None,
                 window: int | None = None):
        self.writable = write
        flags = os.O_RDWR | os.O_CREAT if write else os.O_RDONLY
        self._fd = os.open(path, flags, 0o644)
        self._size = os.fstat(self._fd).st_size
        if write and create_size and create_size > self._size:
            os.ftruncate(self._fd, create_size)
            self._size = create_size
        # logical extent: declared object size / pre-existing bytes / write
        # high-water mark.  Doubling growth over-allocates past it; close()
        # truncates back so the file ends at real data (the reference's
        # writers ftruncate to the object size, lib/io.c:258-300).
        self._logical = self._size
        self._map = None
        page = mmap.ALLOCATIONGRANULARITY
        self._window = -(-window // page) * page if window else None
        self._w0 = 0  # window base offset (window mode only)
        if self._size:
            self._remap()

    def _remap(self, want0: int = 0, wantn: int = 0):
        if self._map is not None:
            self._map.close()
            self._map = None
        acc = mmap.ACCESS_WRITE if self.writable else mmap.ACCESS_READ
        if self._window is None:
            self._map = mmap.mmap(self._fd, self._size, access=acc)
            return
        # slide the window to cover [want0, want0+wantn); windows are
        # window-aligned like the reference's remap-on-seek (io.c:188-236)
        base = (want0 // self._window) * self._window
        length = min(self._size - base, max(self._window, want0 + wantn - base))
        self._w0 = base
        if length > 0:
            self._map = mmap.mmap(self._fd, length, access=acc, offset=base)

    def _view(self, offset: int, n: int):
        """(map, local_offset) covering [offset, offset+n), remapping the
        window if needed."""
        if self._window is None:
            return self._map, offset
        if (self._map is None or offset < self._w0
                or offset + n > self._w0 + len(self._map)):
            self._remap(offset, n)
        return self._map, offset - self._w0

    def _grow(self, need: int):
        newsize = max(need, self._size * 2 if self._size else need)
        os.ftruncate(self._fd, newsize)
        self._size = newsize
        if self._window is None:
            self._remap()
        elif self._map is not None:
            self._map.close()
            self._map = None  # next access remaps against the grown file

    def read_at(self, offset: int, n: int) -> bytes:
        if offset >= self._size:
            return b""
        n = min(n, self._size - offset)
        m, lo = self._view(offset, n)
        return m[lo : lo + n]

    def write_at(self, offset: int, data) -> int:
        data = bytes(data) if not isinstance(data, (bytes, bytearray)) else data
        if offset + len(data) > self._size:
            self._grow(offset + len(data))
        m, lo = self._view(offset, len(data))
        m[lo : lo + len(data)] = data
        self._logical = max(self._logical, offset + len(data))
        return len(data)

    def size(self) -> int:
        return self._size

    def close(self) -> None:
        if self._map is not None:
            self._map.close()
            self._map = None
        if self.writable and self._size > self._logical:
            os.ftruncate(self._fd, self._logical)
        os.close(self._fd)
