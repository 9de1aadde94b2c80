"""Episode video recording, with numpy and the standard library only.

Counterpart of ``icem_tpu/runtime/video.py``. Reference behaviour
(icem/misc/rollout_utils.py:70-81, :174-183): an MJPEG movie plus a
live-updating still of the last frame. ``VideoRecorder`` writes the files the
JAX package writes — ``<name>.avi`` (MJPEG in a RIFF AVI: JPEG frames in
``00dc`` chunks and an ``idx1`` index), ``<name>.gif`` and a
``live_frame.png`` refreshed every ``live_every`` frames — through its own
encoders, since the machines the port runs on carry no image library:

- ``encode_jpeg``: baseline JPEG (JFIF), YCbCr without subsampling, the 8x8
  DCT, the quantization and Huffman tables of ITU T.81 Annex K, the
  entropy coding vectorized over all blocks of a frame;
- ``write_gif``: GIF89a with one local palette per frame and LZW;
- ``write_png``: RGB PNG over ``zlib``.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# JPEG (ITU T.81 baseline; tables from its Annex K)
# ---------------------------------------------------------------------------

_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# (BITS: codes of each length 1..16, HUFFVAL) of tables K.3-K.6
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa))

# ZIGZAG[k]: the row-major index of the k-th coefficient in zigzag order
ZIGZAG = np.array(sorted(range(64), key=lambda n: (
    n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))))

_u = np.arange(8)
_DCT = np.sqrt(np.where(_u == 0, 1.0, 2.0) / 8)[:, None] * np.cos(
    (2 * _u[None, :] + 1) * _u[:, None] * np.pi / 16)       # orthonormal 8-point DCT-II

_RGB_TO_YCBCR = np.array([[0.299, 0.587, 0.114],
                          [-0.168736, -0.331264, 0.5],
                          [0.5, -0.418688, -0.081312]])


def _huffman_codes(table):
    """(code [256], length [256]) of a (BITS, HUFFVAL) table (T.81 Annex C)."""
    bits, vals = table
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


# [table class (0 luma, 1 chroma), symbol] -> code, code length
_DC_CODE, _DC_LEN = (np.stack(t) for t in zip(*map(_huffman_codes, (_DC_LUMA, _DC_CHROMA))))
_AC_CODE, _AC_LEN = (np.stack(t) for t in zip(*map(_huffman_codes, (_AC_LUMA, _AC_CHROMA))))


def _quant_tables(quality: int):
    """The Annex K tables scaled to ``quality`` in [1, 100] as the IJG
    library scales them."""
    q = int(np.clip(quality, 1, 100))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return [np.clip((t * scale + 50) // 100, 1, 255) for t in (_Q_LUMA, _Q_CHROMA)]


def _magnitude(v):
    """(size, bits): the bit length of |v| and the size low bits that code v
    (v itself if v >= 0, else v - 1 in two's complement)."""
    size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    return size, np.where(v >= 0, v, v + (1 << size) - 1)


def _entropy_coded(coef, comp):
    """The Huffman-coded scan of quantized blocks ``coef`` [N, 64] (zigzag
    order, scan order) whose table class is ``comp`` [N] (0 luma, 1 chroma),
    DC already differenced. Returns the bytes, 0xFF-stuffed."""
    N = coef.shape[0]
    # one code per slot: the DC, each AC coefficient 1..63 and the EOB; the
    # slots in row-major order are the order of the scan
    vals = np.zeros((N, 65), np.int64)
    lens = np.zeros((N, 65), np.int64)

    size, bits = _magnitude(coef[:, 0])
    vals[:, 0] = (_DC_CODE[comp, size] << size) | bits
    lens[:, 0] = _DC_LEN[comp, size] + size

    blk, k = np.nonzero(coef[:, 1:])
    k = k + 1                                            # AC positions 1..63
    same = np.concatenate([[False], blk[1:] == blk[:-1]])
    prev = np.where(same, np.concatenate([[0], k[:-1]]), 0)
    run = k - prev - 1                                   # zeros since the last code
    size, bits = _magnitude(coef[blk, k])
    c = comp[blk]
    v = np.zeros_like(k)
    n = np.zeros_like(k)
    for i in range(3):                      # runs of 16 zeros: at most 3 in a block
        more = run >= 16 * (i + 1)
        v = np.where(more, (v << _AC_LEN[c, 0xF0]) | _AC_CODE[c, 0xF0], v)
        n = np.where(more, n + _AC_LEN[c, 0xF0], n)
    sym = ((run % 16) << 4) | size
    clen = _AC_LEN[c, sym]
    vals[blk, k] = (((v << clen) | _AC_CODE[c, sym]) << size) | bits
    lens[blk, k] = n + clen + size
    eob = coef[:, 63] == 0
    vals[eob, 64] = _AC_CODE[comp[eob], 0x00]
    lens[eob, 64] = _AC_LEN[comp[eob], 0x00]

    keep = lens.reshape(-1) > 0
    vals, lens = vals.reshape(-1)[keep], lens.reshape(-1)[keep]
    total = int(lens.sum())
    which = np.repeat(np.arange(len(lens)), lens)
    offset = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    stream = (vals[which] >> (lens[which] - 1 - offset)) & 1
    stream = np.concatenate([stream, np.ones((-total) % 8, np.int64)])   # pad with ones
    data = np.packbits(stream.astype(np.uint8))
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def encode_jpeg(frame, quality: int = 85) -> bytes:
    """A baseline JFIF JPEG of ``frame`` (uint8 [H, W, 3], or [H, W] grey)."""
    img = np.asarray(frame, np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = img[..., :3]
    h, w = img.shape[:2]
    # pad to whole 8x8 blocks by repeating the edge
    padded = np.pad(img, ((0, (-h) % 8), (0, (-w) % 8), (0, 0)), mode="edge")
    ycc = padded.astype(np.float64) @ _RGB_TO_YCBCR.T
    ycc[..., 0] -= 128.0                    # level shift (Cb, Cr are centred on 0)
    H8, W8 = padded.shape[0] // 8, padded.shape[1] // 8
    # [blocks in raster order, component, 8, 8]: the interleaved scan order
    blocks = ycc.reshape(H8, 8, W8, 8, 3).transpose(0, 2, 4, 1, 3).reshape(-1, 3, 8, 8)
    dct = (_DCT @ blocks @ _DCT.T).reshape(-1, 3, 64)
    quant = _quant_tables(quality)
    q = np.stack([quant[0], quant[1], quant[1]])                  # [3, 64]
    coef = np.round(dct / q).astype(np.int64)[:, :, ZIGZAG]       # [N, 3, 64]
    coef[:, :, 0] = np.diff(coef[:, :, 0], axis=0, prepend=0)     # DC prediction
    comp = np.tile([0, 1, 1], coef.shape[0])
    scan = _entropy_coded(coef.reshape(-1, 64), comp)

    out = [b"\xff\xd8",
           _segment(0xFFE0, b"JFIF\0" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0))]
    out.append(_segment(0xFFDB, b"".join(
        bytes([i]) + t[ZIGZAG].astype(np.uint8).tobytes() for i, t in enumerate(quant))))
    out.append(_segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])))
    dht = b""
    for cls_id, (bits, vals) in ((0x00, _DC_LUMA), (0x10, _AC_LUMA),
                                 (0x01, _DC_CHROMA), (0x11, _AC_CHROMA)):
        dht += bytes([cls_id]) + bytes(bits) + bytes(vals)
    out.append(_segment(0xFFC4, dht))
    out.append(_segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_mjpeg_avi(path: str, frames, fps: float = 20.0, quality: int = 85) -> str:
    """Mux ``frames`` (HxWx3 uint8) into an MJPEG AVI at ``path``.

    Standard RIFF layout: hdrl(avih + strl(strh 'vids'/'MJPG' + strf
    BITMAPINFOHEADER)) + movi('00dc' JPEG chunks, even-padded) + idx1.
    Reference analog: the imageio mjpeg writer used by
    rollout_utils.py:70-81.
    """
    h, w = np.asarray(frames[0]).shape[:2]
    jpegs = [encode_jpeg(f, quality) for f in frames]
    n = len(jpegs)
    max_size = max(len(j) for j in jpegs)

    def chunk(fcc, payload):
        pad = b"\0" if len(payload) % 2 else b""
        return fcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(fourcc, payload):
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack(
        "<14I", int(1e6 / fps), max_size * int(fps) + 1, 0, 0x10, n, 0, 1,
        max_size, w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"MJPG" + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1,
                                            int(round(fps)), 0, n, max_size,
                                            -1, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3,
                       0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi, index, at = [], [], 4
    for j in jpegs:
        # idx1 offsets are measured from the 'movi' fourcc position
        index.append(b"00dc" + struct.pack("<III", 0x10, at, len(j)))
        movi.append(chunk(b"00dc", j))
        at += len(movi[-1])
    body = b"AVI " + hdrl + lst(b"movi", b"".join(movi)) + chunk(b"idx1", b"".join(index))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


# ---------------------------------------------------------------------------
# GIF89a
# ---------------------------------------------------------------------------


def _palette(frame):
    """(palette [n, 3] uint8, indices [H*W] uint8) of an RGB frame: its own
    colours where it has at most 256 (exact), else the 3-3-2 bit cube."""
    rgb = frame.reshape(-1, 3).astype(np.int64)
    keys = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    colours, idx = np.unique(keys, return_inverse=True)
    if len(colours) <= 256:
        pal = np.stack([colours >> 16, (colours >> 8) & 255, colours & 255], -1)
        return pal.astype(np.uint8), idx.astype(np.uint8)
    cube = np.arange(256)
    pal = np.stack([(cube >> 5) * 255 // 7, ((cube >> 2) & 7) * 255 // 7,
                    (cube & 3) * 255 // 3], -1)
    idx = ((rgb[:, 0] >> 5) << 5) | ((rgb[:, 1] >> 5) << 2) | (rgb[:, 2] >> 6)
    return pal.astype(np.uint8), idx.astype(np.uint8)


def _lzw(indices, min_code_size: int) -> bytes:
    """GIF's variable-width LZW of a sequence of palette indices, bits
    packed least significant first; a full table (4,096 codes) is cleared."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    size, next_code, table = min_code_size + 1, eoi + 1, {}
    emit(clear, size)
    data = indices.tolist()
    prefix = data[0]
    for k in data[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, size)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            # the decoder adds each entry one code later, so the width grows
            # once the table holds an entry that needs the wider code
            if next_code > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear, size)
            size, next_code, table = min_code_size + 1, eoi + 1, {}
        prefix = k
    emit(prefix, size)
    emit(eoi, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_delay_cs(fps: float) -> int:
    """The GIF frame delay in centiseconds, the unit the format stores:
    round(100 / fps), and at least 2 (viewers play shorter delays slower).
    The JAX package passes imageio a duration whose unit is seconds in one
    of its APIs and milliseconds in another; a delay in the wrong unit plays
    a GIF about a thousand times too fast or too slow."""
    return max(2, int(round(100.0 / fps)))


def write_gif(path: str, frames, fps: float = 20.0) -> str:
    """An animated GIF89a of ``frames`` (uint8 [H, W, 3]) that loops
    forever, each frame with its own palette. Frames of at most 256 colours
    decode to exactly what was written."""
    frames = [np.asarray(f, np.uint8)[..., :3] for f in frames]
    h, w = frames[0].shape[:2]
    delay = gif_delay_cs(fps)
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]     # loop forever
    for f in frames:
        pal, idx = _palette(f)
        bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))    # table of 2**bits
        table = np.zeros((1 << bits, 3), np.uint8)
        table[: len(pal)] = pal
        min_code = max(2, bits)
        lzw = _lzw(idx, min_code)
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | (bits - 1)))
        out.append(table.tobytes() + bytes([min_code]))
        out.extend(bytes([len(lzw[i:i + 255])]) + lzw[i:i + 255]
                   for i in range(0, len(lzw), 255))
        out.append(b"\x00")
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    return path


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def write_png(path: str, frame) -> str:
    """An 8-bit RGB PNG of ``frame`` (uint8 [H, W, 3]), every row unfiltered."""
    img = np.asarray(frame, np.uint8)[..., :3]
    h, w = img.shape[:2]

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(data)
    return path


class VideoRecorder:
    """Accumulates frames for one episode and writes <name>.avi and
    <name>.gif, and a live PNG of frames 1, 1 + live_every, ..."""

    def __init__(self, directory: str, name: str, fps: float = 20.0, live_every: int = 10):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{name}.gif")
        self.avi_path = os.path.join(directory, f"{name}.avi")
        self.live_path = os.path.join(directory, "live_frame.png")
        self.fps = float(fps)
        self.live_every = int(live_every)
        self._frames = []

    def append(self, frame: np.ndarray):
        frame = np.asarray(frame, np.uint8)
        self._frames.append(frame)
        if (len(self._frames) - 1) % self.live_every == 0:
            write_png(self.live_path, frame)      # a failed write raises

    def close(self) -> Optional[str]:
        """Writes the files; returns the GIF's path, None without frames."""
        if not self._frames:
            return None
        # the reference's movie artifact is MJPEG (rollout_utils.py:70-81)
        write_mjpeg_avi(self.avi_path, self._frames, fps=self.fps)
        write_gif(self.path, self._frames, fps=self.fps)
        self._frames = []
        return self.path
