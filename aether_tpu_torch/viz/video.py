"""Video export with graceful backend fallback.

The reference writes mp4 via imageio+ffmpeg (``scripts/demo.py:484-520``). This
image ships imageio but no ffmpeg/pyav backend, so ``save_video`` tries ffmpeg
mp4 (H.264 where available), then MJPEG-in-MP4 (a dependency-free ISO BMFF
muxer below — a real ``.mp4`` artifact, JPEG samples declared via ``esds``
OTI 0x6C), then MJPEG-in-AVI (RIFF muxer), then GIF, then a directory of PNG
frames — and reports which one it used.

Copy of ``aether_tpu/viz/video.py``. ``imageio`` and PIL are imported only
inside the writers; the GPU host has neither, so the MP4/GIF writers run on
hosts that have them (the CPU tests).
"""

from __future__ import annotations

import os
import struct
from typing import Union

import numpy as np


def write_mjpeg_avi(
    path: Union[str, os.PathLike],
    frames: np.ndarray,
    fps: int = 12,
    quality: int = 90,
) -> str:
    """Write (T, H, W, 3) uint8 frames as an MJPEG AVI (RIFF) file.

    Pure-stdlib container muxing; per-frame JPEG encoding via PIL (native C).
    Replaces the reference's ffmpeg mp4 path on ffmpeg-less machines with a
    real video artifact instead of a 256-color GIF.
    """
    import io

    from PIL import Image

    frames = _to_uint8(frames)
    t, h, w = frames.shape[:3]
    jpegs = []
    for frame in frames:
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
        data = buf.getvalue()
        if len(data) % 2:
            data += b"\x00"
        jpegs.append(data)
    max_size = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack(
        "<14I",
        1_000_000 // fps,  # dwMicroSecPerFrame
        max_size * fps,  # dwMaxBytesPerSec
        0,  # dwPaddingGranularity
        0x10,  # dwFlags: AVIF_HASINDEX
        t, 0, 1,  # totalframes, initialframes, streams
        max_size, w, h, 0, 0, 0, 0,
    )
    strh = (
        b"vids" + b"MJPG"
        + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps, 0, t,
                      max_size, 0xFFFFFFFF, 0)
        + struct.pack("<4h", 0, 0, w, h)
    )
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_payload = b"".join(chunk(b"00dc", j) for j in jpegs)
    movi = lst(b"movi", movi_payload)

    idx, offset = [], 4  # offsets relative to the start of 'movi' fourcc
    for j in jpegs:
        idx.append(struct.pack("<4sIII", b"00dc", 0x10, offset, len(j)))
        offset += 8 + len(j)
    idx1 = chunk(b"idx1", b"".join(idx))

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)
    return str(path)


def write_mjpeg_mp4(
    path: Union[str, os.PathLike],
    frames: np.ndarray,
    fps: int = 12,
    quality: int = 90,
) -> str:
    """Write (T, H, W, 3) uint8 frames as Motion-JPEG in an ISO BMFF ``.mp4``.

    The reference ships mp4 artifacts via imageio+ffmpeg
    (``scripts/demo.py:484-520``); this image has no ffmpeg, so H.264 is out of
    reach — but the *container* isn't. ISO/IEC 14496-1 assigns
    objectTypeIndication 0x6C to ISO/IEC 10918-1 (JPEG), so an ``mp4v`` sample
    entry whose ``esds`` declares OTI 0x6C carries plain JPEG samples in a
    fully standards-compliant MP4 that ffmpeg/VLC/QuickTime demux as MJPEG.
    Pure-stdlib muxing; per-frame JPEG encoding via PIL (native C). Every
    sample is a sync sample (no ``stss``), timing is exact (mdhd timescale =
    fps, delta 1).
    """
    import io

    from PIL import Image

    frames = _to_uint8(frames)
    t, h, w = frames.shape[:3]
    jpegs = []
    for frame in frames:
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
        jpegs.append(buf.getvalue())

    def box(fourcc: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", 8 + len(payload)) + fourcc + payload

    def full(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
        return box(fourcc, struct.pack(">I", (version << 24) | flags) + payload)

    def desc(tag: int, payload: bytes) -> bytes:
        # MPEG-4 systems expandable length: minimal-byte base-128 encoding
        n = len(payload)
        size = bytes([n & 0x7F])
        n >>= 7
        while n:
            size = bytes([0x80 | (n & 0x7F)]) + size
            n >>= 7
        return bytes([tag]) + size + payload

    ftyp = box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    mdat = box(b"mdat", b"".join(jpegs))

    # --- moov ---------------------------------------------------------------
    mvhd = full(b"mvhd", 0, 0, struct.pack(
        ">IIIII", 0, 0, 1000, t * 1000 // fps, 0x00010000)
        + struct.pack(">H", 0x0100) + b"\x00" * 10  # reserved: 2 + 4*2
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + b"\x00" * 24 + struct.pack(">I", 2))  # next track id
    tkhd = full(b"tkhd", 0, 3, struct.pack(
        ">IIIII", 0, 0, 1, 0, t * 1000 // fps) + b"\x00" * 16
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + struct.pack(">II", w << 16, h << 16))
    mdhd = full(b"mdhd", 0, 0,
                struct.pack(">IIIIHH", 0, 0, fps, t, 0x55C4, 0))  # und
    hdlr = full(b"hdlr", 0, 0, struct.pack(">I", 0) + b"vide"
                + b"\x00" * 12 + b"VideoHandler\x00")

    bufsize = max(len(j) for j in jpegs)
    rate = bufsize * fps * 8
    dcfg = desc(0x04, struct.pack(">BB", 0x6C, (4 << 2) | 1)
                + struct.pack(">I", bufsize)[1:]  # 24-bit bufferSizeDB
                + struct.pack(">II", rate, rate))
    es = desc(0x03, struct.pack(">HB", 1, 0) + dcfg + desc(0x06, b"\x02"))
    esds = full(b"esds", 0, 0, es)
    mp4v = box(b"mp4v", b"\x00" * 6 + struct.pack(">H", 1)
               + b"\x00" * 16 + struct.pack(">HH", w, h)
               + struct.pack(">IIIH", 0x00480000, 0x00480000, 0, 1)
               + b"\x00" * 32 + struct.pack(">Hh", 24, -1) + esds)
    stsd = full(b"stsd", 0, 0, struct.pack(">I", 1) + mp4v)
    stts = full(b"stts", 0, 0, struct.pack(">III", 1, t, 1))
    stsc = full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, t, 1))
    stsz = full(b"stsz", 0, 0, struct.pack(">II", 0, t)
                + b"".join(struct.pack(">I", len(j)) for j in jpegs))
    stco = full(b"stco", 0, 0,
                struct.pack(">II", 1, len(ftyp) + 8))  # mdat payload offset
    stbl = box(b"stbl", stsd + stts + stsc + stsz + stco)
    dinf = box(b"dinf", full(b"dref", 0, 0, struct.pack(">I", 1)
                             + full(b"url ", 0, 1, b"")))
    minf = box(b"minf", full(b"vmhd", 0, 1, b"\x00" * 8) + dinf + stbl)
    mdia = box(b"mdia", mdhd + hdlr + minf)
    moov = box(b"moov", mvhd + box(b"trak", tkhd + mdia))

    with open(path, "wb") as f:
        f.write(ftyp + mdat + moov)
    return str(path)


def _to_uint8(frames: np.ndarray) -> np.ndarray:
    frames = np.asarray(frames)
    if frames.dtype == np.uint8:
        return frames
    if frames.max() <= 1.0 + 1e-6:
        frames = frames * 255.0
    return np.clip(frames, 0, 255).astype(np.uint8)


def save_video(
    path: Union[str, os.PathLike],
    frames: np.ndarray,
    fps: int = 12,
) -> str:
    """Write (T, H, W, 3) frames to ``path``. Returns the path actually written
    (extension may change if the mp4 backend is unavailable)."""
    import imageio

    frames = _to_uint8(frames)
    path = str(path)

    if path.endswith(".mp4"):
        try:
            writer = imageio.get_writer(path, fps=fps)
            for frame in frames:
                writer.append_data(frame)
            writer.close()
            return path
        except Exception:
            pass
        try:
            # ffmpeg-less: a real .mp4 all the same (MJPEG in ISO BMFF)
            return write_mjpeg_mp4(path, frames, fps=fps)
        except Exception:
            path = path[: -len(".mp4")] + ".avi"

    if path.endswith(".avi"):
        try:
            return write_mjpeg_avi(path, frames, fps=fps)
        except Exception:
            path = path[: -len(".avi")] + ".gif"

    if path.endswith(".gif"):
        try:
            imageio.mimsave(path, list(frames), duration=1000.0 / fps, loop=0)
            return path
        except Exception:
            path = path[: -len(".gif")]

    os.makedirs(path, exist_ok=True)
    for i, frame in enumerate(frames):
        imageio.imwrite(os.path.join(path, f"frame_{i:04d}.png"), frame)
    return path
