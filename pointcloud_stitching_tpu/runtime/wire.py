"""Wire protocol: framing, codecs, and point packing.

Host-side equivalent of the reference's TCP transport (reference:
src/pcs-camera-server.cpp / src/pcs-multicamera-client.cpp — 4-byte
length-prefixed frames, snappy-compressed payload of int16-millimeter XYZ +
RGB bytes; SURVEY.md §1 L1 and §2.5).

Two payload kinds:
  * DEPTH16 — raw uint16 depth frames. The default streaming mode:
    deprojection moved on-device (BASELINE: "the host keeps only camera
    capture and socket ingest"), so the wire carries what the sensor
    produces. 848x480 u16 ≈ 814 KB raw, typically 350-500 KB compressed.
  * POINTS_I16MM — the reference's packed point format (int16 mm XYZ
    [+ u8 RGB]), kept for interop with reference camera servers.

Codecs: RAW, ZLIB (stdlib), SNAPPY (native C++ extension in
pointcloud_stitching_tpu/native, reference-compatible; optional at runtime).

Frame layout (little-endian):
  u32 payload_size | u8 kind | u8 codec | u8 flags | u8 reserved |
  u32 seq | u16 rows | u16 cols | payload
The leading u32 size keeps the reference's "size-then-body" shape so a
blocking reader needs exactly two reads per frame.
"""
from __future__ import annotations

import enum
import socket
import struct
import zlib
from typing import Optional

import numpy as np

_HEADER = struct.Struct("<IBBBBIHH")  # size, kind, codec, flags, rsvd, seq, rows, cols
HEADER_SIZE = _HEADER.size

PULL = b"\x01"  # client→server frame request (reference: 1-byte pull)


class Kind(enum.IntEnum):
    DEPTH16 = 0
    POINTS_I16MM = 1
    DEPTH16_COLOR = 2  # depth u16 + depth-aligned RGB u8 after depth block
    # depth u16 + color at the COLOR stream's own resolution (u16 crows,
    # u16 ccols, then RGB u8) — for cameras that don't run the rs2 align
    # block; the device texture-maps it (ops.deproject.map_color)
    DEPTH16_COLOR_NATIVE = 3


class Codec(enum.IntEnum):
    RAW = 0
    ZLIB = 1
    SNAPPY = 2


def _get_snappy():
    try:
        from ..native import snappy as _snappy  # C++ extension
        return _snappy
    except Exception:
        return None


def compress(data: bytes, codec: Codec) -> bytes:
    if codec == Codec.RAW:
        return data
    if codec == Codec.ZLIB:
        return zlib.compress(data, level=1)
    if codec == Codec.SNAPPY:
        sn = _get_snappy()
        if sn is None:
            raise RuntimeError("native snappy codec not built")
        return sn.compress(data)
    raise ValueError(codec)


def _snappy_preamble_len(data: bytes) -> int:
    """Uncompressed length from the snappy varint preamble (no alloc)."""
    ulen, shift = 0, 0
    for i in range(min(len(data), 5)):
        b = data[i]
        ulen |= (b & 0x7F) << shift
        if not (b & 0x80):
            return ulen
        shift += 7
    raise ValueError("bad snappy length preamble")


def decompress(data: bytes, codec: Codec,
               max_out: Optional[int] = None) -> bytes:
    """Decompress with an optional output bound.

    max_out guards the DECOMPRESSED size: the framing layer caps the
    compressed body (MAX_FRAME_BYTES) but a corrupt/hostile stream can
    claim a multi-GB expansion (zlib bomb; snappy's varint preamble
    addresses up to 4 GB) which would be allocated before any shape
    validation runs. Bounded decode fails fast with ValueError instead.
    """
    if codec == Codec.RAW:
        return data
    if codec == Codec.ZLIB:
        if max_out is None:
            return zlib.decompress(data)
        d = zlib.decompressobj()
        out = d.decompress(data, max_out + 1)
        if len(out) > max_out or d.unconsumed_tail:
            raise ValueError(f"zlib payload exceeds {max_out} bytes "
                             "(corrupt stream?)")
        if not d.eof:
            raise zlib.error("incomplete zlib stream")
        return out
    if codec == Codec.SNAPPY:
        sn = _get_snappy()
        if sn is None:
            raise RuntimeError("native snappy codec not built")
        if max_out is not None and _snappy_preamble_len(data) > max_out:
            raise ValueError(f"snappy payload claims more than {max_out} "
                             "bytes (corrupt stream?)")
        return sn.decompress(data)
    raise ValueError(codec)


# ---------------------------------------------------------------------------
# Point packing — the reference's int16-millimeter bandwidth optimization
# ---------------------------------------------------------------------------

def pack_points_i16mm(xyz_m: np.ndarray, rgb: Optional[np.ndarray] = None
                      ) -> bytes:
    """Pack float-meter points to int16 millimeters (+u8 RGB), vectorized.

    Reference equivalent: the server's hot pack loop (SURVEY.md §3.1) —
    there a scalar loop over ~400k points; here one numpy round+cast.
    """
    pts = np.clip(np.round(np.asarray(xyz_m, np.float32) * 1000.0),
                  -32768, 32767).astype("<i2")
    if rgb is None:
        return pts.tobytes()
    rec = np.empty(len(pts), dtype=np.dtype([("xyz", "<i2", 3),
                                             ("rgb", "u1", 3)]))
    rec["xyz"] = pts
    rec["rgb"] = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)
    return rec.tobytes()


def unpack_points_i16mm(data: bytes, with_rgb: bool = False):
    """Inverse of pack_points_i16mm. Returns (xyz_m f32 [N,3], rgb u8 or None)."""
    if with_rgb:
        rec = np.frombuffer(data, dtype=np.dtype([("xyz", "<i2", 3),
                                                  ("rgb", "u1", 3)]))
        return rec["xyz"].astype(np.float32) / 1000.0, rec["rgb"].copy()
    pts = np.frombuffer(data, dtype="<i2").reshape(-1, 3)
    return pts.astype(np.float32) / 1000.0, None


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

FLAG_HAS_RGB = 0x01


def encode_frame(payload: bytes, kind: Kind, codec: Codec, seq: int,
                 rows: int = 0, cols: int = 0, flags: int = 0) -> bytes:
    body = compress(payload, codec)
    return _HEADER.pack(len(body), int(kind), int(codec), flags, 0,
                        seq & 0xFFFFFFFF, rows, cols) + body


def encode_depth_frame(depth: np.ndarray, seq: int,
                       codec: Codec = Codec.ZLIB,
                       color: Optional[np.ndarray] = None) -> bytes:
    """Depth frame, optionally with depth-aligned RGB appended (the colored
    stream mode — reference equivalent: rs2 color stream + map_to)."""
    depth = np.ascontiguousarray(depth, dtype="<u2")
    if color is None:
        return encode_frame(depth.tobytes(), Kind.DEPTH16, codec, seq,
                            rows=depth.shape[0], cols=depth.shape[1])
    color = np.ascontiguousarray(color, dtype=np.uint8)
    if color.shape[:2] == depth.shape:
        return encode_frame(depth.tobytes() + color.tobytes(),
                            Kind.DEPTH16_COLOR, codec, seq,
                            rows=depth.shape[0], cols=depth.shape[1])
    # non-aligned color stream: ship it at its own resolution, dims inline
    ch, cw = color.shape[:2]
    return encode_frame(depth.tobytes() + struct.pack("<HH", ch, cw)
                        + color.tobytes(),
                        Kind.DEPTH16_COLOR_NATIVE, codec, seq,
                        rows=depth.shape[0], cols=depth.shape[1])


def decode_frame(header: bytes, body: bytes):
    """Returns (kind, seq, payload).

    DEPTH16 → [rows, cols] uint16. DEPTH16_COLOR → (depth u16, rgb u8
    [rows, cols, 3]). POINTS_I16MM → raw bytes (use unpack_points_i16mm
    with with_rgb=<FLAG_HAS_RGB set>).
    """
    size, kind, codec, flags, _r, seq, rows, cols = _HEADER.unpack(header)
    raw = decompress(body, Codec(codec), max_out=MAX_FRAME_BYTES)
    if kind == Kind.DEPTH16:
        arr = np.frombuffer(raw, dtype="<u2").reshape(rows, cols)
        return Kind.DEPTH16, seq, arr
    if kind == Kind.DEPTH16_COLOR:
        nd = rows * cols * 2
        depth = np.frombuffer(raw[:nd], dtype="<u2").reshape(rows, cols)
        rgb = np.frombuffer(raw[nd:], dtype=np.uint8).reshape(rows, cols, 3)
        return Kind.DEPTH16_COLOR, seq, (depth, rgb)
    if kind == Kind.DEPTH16_COLOR_NATIVE:
        nd = rows * cols * 2
        depth = np.frombuffer(raw[:nd], dtype="<u2").reshape(rows, cols)
        ch, cw = struct.unpack_from("<HH", raw, nd)
        rgb = np.frombuffer(raw[nd + 4:], dtype=np.uint8).reshape(ch, cw, 3)
        return Kind.DEPTH16_COLOR_NATIVE, seq, (depth, rgb)
    if kind == Kind.POINTS_I16MM:
        return (Kind.POINTS_I16MM, seq,
                unpack_points_i16mm(raw, with_rgb=bool(flags & FLAG_HAS_RGB)))
    return Kind(kind), seq, raw


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return bytes(buf)


MAX_FRAME_BYTES = 64 * 2 ** 20  # sanity bound; a D435 frame is < 1 MB


def recv_frame(sock: socket.socket):
    header = recv_exact(sock, HEADER_SIZE)
    size = struct.unpack_from("<I", header)[0]
    if size > MAX_FRAME_BYTES:
        # garbage on the wire decodes as an absurd length; fail fast instead
        # of blocking on a gigabyte recv
        raise ValueError(f"frame size {size} exceeds {MAX_FRAME_BYTES} "
                         "(corrupt stream?)")
    body = recv_exact(sock, size)
    return decode_frame(header, body)


def send_pull(sock: socket.socket) -> None:
    sock.sendall(PULL)
