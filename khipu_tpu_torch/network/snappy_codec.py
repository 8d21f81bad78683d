"""Minimal Snappy block-format codec (devp2p p2p/v5 frame compression).

The port's copy of ``khipu_tpu.network.snappy_codec``. The reference
pulls in snappy-java (SURVEY §2.10); here ``compress`` is the C
extension's greedy matcher (``native/csrc_ext/rlp_ext.c``
``snappy_compress``) and a failed build raises, as the other native
builds do. ``decompress`` is Python (literals + all copy tags).
``_compress_literal`` is the oracle the tests round-trip against; it is
never a fallback.
"""

from __future__ import annotations


class SnappyError(Exception):
    pass


def _read_varint(data: bytes, pos: int):
    out = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint overflow")


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _compress_literal(data: bytes) -> bytes:
    """All-literal encoding: varint(len) + ONE extended-length literal
    (tags 60-63 carry a 1-4 byte little-endian length) — O(1) overhead
    regardless of payload size. Valid Snappy; the oracle the C
    compressor is round-tripped against."""
    out = bytearray(_write_varint(len(data)))
    if not data:
        return bytes(out)
    n = len(data)
    if n <= 60:
        out.append((n - 1) << 2)
    else:
        length_bytes = (n - 1).to_bytes(
            ((n - 1).bit_length() + 7) // 8, "little"
        )
        out.append((59 + len(length_bytes)) << 2)  # tag 60..63
        out.extend(length_bytes)
    out.extend(data)
    return bytes(out)


_c_compress = None


def compress(data: bytes) -> bytes:
    """Greedy compression through the C extension (hash-table matcher,
    copy-with-2-byte-offset ops — RLP wire payloads shrink ~2-20x). The
    extension resolves ONCE (this sits on the per-frame send path);
    a failed build raises."""
    global _c_compress
    if _c_compress is None:
        from khipu_tpu_torch.native.build import load_rlp_ext

        _c_compress = load_rlp_ext().snappy_compress
    return _c_compress(data)


def decompress(data: bytes, max_len: int = 1 << 24) -> bytes:
    total, pos = _read_varint(data, 0)
    if total > max_len:
        raise SnappyError(f"declared length {total} > cap {max_len}")
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            n = (tag >> 2) + 1
            if n > 60:
                extra = n - 60
                if extra > 4:
                    raise SnappyError("bad literal length")
                n = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            out += data[pos : pos + n]
            pos += n
        else:  # copy
            if kind == 1:
                n = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:
                n = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:
                n = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out):
                raise SnappyError("bad copy offset")
            start = len(out) - offset
            for i in range(n):  # may overlap: byte-at-a-time
                out.append(out[start + i])
        if len(out) > max_len:
            raise SnappyError("output exceeds cap")
    if len(out) != total:
        raise SnappyError(f"length mismatch {len(out)} != {total}")
    return bytes(out)
