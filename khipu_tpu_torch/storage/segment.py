"""Append-only segment files: length-prefixed, CRC-framed records.

The port's counterpart of ``khipu_tpu.storage.segment``, byte for byte
the same files (parity: khipu-eth's Kesque engine stores every topic as
a Kafka-style log of framed records, KesqueDataSource.scala). This
module is the file layer under ``storage/kesque.py``. One ``Segment``
is one file of back-to-back frames:

    +----------+----------+------------------+
    | len u32  | crc u32  | payload (len B)  |
    +----------+----------+------------------+

``crc`` is CRC-32 over the payload. A frame is valid iff its header is
complete, ``len`` passes the sanity cap, the payload is fully present
and the CRC matches. The file layer knows nothing about keys or
values — payload semantics (node records, tombstones) live in
kesque.py.

Crash contract (docs/kesque.md, docs/recovery.md): appends are
positional writes at the committed end, chunked through the
``kesque.append`` chaos seam so an injected death tears a frame
mid-write exactly like a real power cut. ``Segment.open`` scans
forward from offset 0 and TRUNCATES the file back to the last valid
frame boundary — a torn tail can lose the in-flight suffix but can
never be served, and the window journal's recovery walk
(sync/journal.py ``verify_reachable(verify_hashes=True)``) then
classifies the lost records as ``missing`` and rolls the torn window
back bit-exact.

Reads are positional (``os.pread``) so concurrent readers never share
a file cursor with the appender.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, List, Tuple

from khipu_tpu_torch.chaos import fault_point

FRAME_HEADER = 8  # u32 len + u32 crc32
_HDR = struct.Struct(">II")
# sanity cap: no single record (node RLP, code blob, block body) comes
# within orders of magnitude of this — a bigger length is torn bytes
MAX_FRAME_PAYLOAD = 1 << 30
# append chunk: each chunk write passes the kesque.append seam, so a
# seeded death can land at any 4 KiB boundary inside a frame
WRITE_CHUNK = 4096


class SegmentCorruptError(Exception):
    """A framed read failed its CRC/length check — torn or bit-flipped
    bytes reached a serving path (the open-time scan-back should have
    truncated them; mid-life corruption is a disk fault)."""


def frame(payload: bytes) -> bytes:
    """One encoded frame: header + payload."""
    if len(payload) > MAX_FRAME_PAYLOAD:
        raise ValueError(f"frame payload too large: {len(payload)}")
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def scan_frames(data: bytes, base: int = 0) -> Tuple[List[Tuple[int, bytes]], int]:
    """Scan ``data`` (the file bytes from offset ``base``) into
    ``([(absolute_offset, payload), ...], valid_end)`` where
    ``valid_end`` is the absolute offset just past the last VALID
    frame — the scan-back truncation point. Stops at the first torn,
    oversized or CRC-failing frame."""
    out: List[Tuple[int, bytes]] = []
    pos = 0
    n = len(data)
    while pos + FRAME_HEADER <= n:
        ln, crc = _HDR.unpack_from(data, pos)
        if ln > MAX_FRAME_PAYLOAD or pos + FRAME_HEADER + ln > n:
            break
        payload = data[pos + FRAME_HEADER : pos + FRAME_HEADER + ln]
        if zlib.crc32(payload) != crc:
            break
        out.append((base + pos, payload))
        pos += FRAME_HEADER + ln
    return out, base + pos


class Segment:
    """One append-only segment file. NOT thread-safe by itself — the
    owning KesqueStore serializes appends and index swaps under its
    lock; positional reads are safe against the appender by
    construction (``pread`` past ``end`` is never issued because the
    index only ever points inside the committed prefix)."""

    def __init__(self, path: str, seq: int):
        self.path = path
        self.seq = seq
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        self.end = os.fstat(self._fd).st_size  # committed end

    # ------------------------------------------------------------- open

    @classmethod
    def open(cls, path: str, seq: int) -> Tuple["Segment", int]:
        """Open an existing (or fresh) segment, scanning forward from
        offset 0 and truncating any torn tail. Returns
        ``(segment, truncated_bytes)``."""
        seg = cls(path, seq)
        size = seg.end
        if size == 0:
            return seg, 0
        data = os.pread(seg._fd, size, 0)
        _, valid_end = scan_frames(data)
        torn = size - valid_end
        if torn:
            os.ftruncate(seg._fd, valid_end)
            seg.end = valid_end
        return seg, torn

    # ----------------------------------------------------------- append

    def append(self, payload: bytes) -> Tuple[int, int]:
        """Append one framed record at the committed end; returns
        ``(offset, frame_bytes)``. The write is chunked through the
        ``kesque.append`` chaos seam: an injected death mid-loop leaves
        a torn frame past ``end`` for the open-time scan-back to
        truncate; an injected *raise* leaves ``end`` untouched, so the
        next append simply overwrites the torn bytes."""
        buf = frame(payload)
        off = self.end
        pos = off
        for i in range(0, len(buf), WRITE_CHUNK):
            fault_point("kesque.append")
            chunk = buf[i : i + WRITE_CHUNK]
            os.pwrite(self._fd, chunk, pos)
            pos += len(chunk)
        self.end = pos
        return off, len(buf)

    def append_many(self, payloads: List[bytes]) -> List[Tuple[int, int]]:
        """Append a batch of framed records as ONE sequential chunked
        write — the bulk-spill fast path (a window's whole mirror tile
        is a few hundred pwrites of WRITE_CHUNK, not one syscall per
        node). Returns ``[(offset, frame_bytes), ...]`` in order. Crash
        semantics are identical to per-record ``append``: ``end`` moves
        only after the last chunk, so a death mid-loop leaves complete
        leading frames (kept by the open-time scan) and one torn frame
        (truncated) — exactly the records that were durably written."""
        bufs = [frame(p) for p in payloads]
        locs: List[Tuple[int, int]] = []
        off = self.end
        for b in bufs:
            locs.append((off, len(b)))
            off += len(b)
        buf = b"".join(bufs)
        mv = memoryview(buf)
        pos = self.end
        for i in range(0, len(buf), WRITE_CHUNK):
            fault_point("kesque.append")
            chunk = mv[i : i + WRITE_CHUNK]
            os.pwrite(self._fd, chunk, pos)
            pos += len(chunk)
        self.end = pos
        return locs

    def append_raw(self, raw: bytes) -> int:
        """Append pre-framed bytes verbatim; returns the base offset.
        The segment-streamed ingest fast path: a shipped chunk is
        whole valid frames by contract (the caller has scanned and
        verified them), so re-framing would just re-CRC identical
        bytes. Crash semantics are identical to ``append_many`` —
        ``end`` moves only after the last chunk."""
        mv = memoryview(raw)
        off = self.end
        pos = off
        for i in range(0, len(raw), WRITE_CHUNK):
            fault_point("kesque.append")
            chunk = mv[i : i + WRITE_CHUNK]
            os.pwrite(self._fd, chunk, pos)
            pos += len(chunk)
        self.end = pos
        return off

    # ------------------------------------------------------------- read

    def read(self, offset: int) -> bytes:
        """Read the frame payload at ``offset`` (CRC-checked)."""
        hdr = os.pread(self._fd, FRAME_HEADER, offset)
        if len(hdr) < FRAME_HEADER:
            raise SegmentCorruptError(
                f"{self.path}@{offset}: truncated frame header"
            )
        ln, crc = _HDR.unpack(hdr)
        if ln > MAX_FRAME_PAYLOAD:
            raise SegmentCorruptError(
                f"{self.path}@{offset}: implausible frame length {ln}"
            )
        payload = os.pread(self._fd, ln, offset + FRAME_HEADER)
        if len(payload) < ln or zlib.crc32(payload) != crc:
            raise SegmentCorruptError(
                f"{self.path}@{offset}: frame failed CRC"
            )
        return payload

    def scan(self) -> Iterator[Tuple[int, bytes]]:
        """All valid frames, in append order."""
        data = os.pread(self._fd, self.end, 0)
        frames, _ = scan_frames(data)
        return iter(frames)

    def read_chunk(self, offset: int, max_bytes: int) -> Tuple[bytes, int, bool]:
        """A raw byte range of WHOLE frames starting at ``offset``:
        ``(raw, next_offset, done)``. The cut lands on a frame
        boundary so the receiver can parse the chunk standalone —
        the segment-streaming unit (fast-sync ingest, rebalance
        segment-ship). Never serves past the committed end. Always
        ships at least one frame, so one oversized record cannot
        wedge the stream."""
        end = self.end
        if offset >= end:
            return b"", end, True
        data = os.pread(self._fd, min(end - offset, max(max_bytes, FRAME_HEADER + 1)), offset)
        frames, valid_end = scan_frames(data, base=offset)
        if not frames:
            # the next frame alone exceeds max_bytes: read it whole
            hdr = os.pread(self._fd, FRAME_HEADER, offset)
            ln, _crc = _HDR.unpack(hdr)
            data = os.pread(self._fd, FRAME_HEADER + ln, offset)
            frames, valid_end = scan_frames(data, base=offset)
            if not frames:
                raise SegmentCorruptError(
                    f"{self.path}@{offset}: unreadable frame mid-log"
                )
        raw = data[: valid_end - offset]
        return raw, valid_end, valid_end >= end

    # -------------------------------------------------------- lifecycle

    def flush(self) -> None:
        os.fsync(self._fd)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def unlink(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
