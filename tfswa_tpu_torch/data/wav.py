"""WAV chunk reader and PCM16 writer in numpy (counterpart of
``tfswa_tpu/native/wav_reader.cpp``).

A RIFF/WAVE parser with positioned reads: the data chunk is mapped with
``np.memmap`` and only the frames asked for are converted, to planar
float32 (channels, frames).  Frames past the end read as zeros, a mono
file is duplicated across the output channels, and a data chunk that
claims more bytes than the file holds reads as far as the file goes.
Encodings: PCM16, PCM24, PCM32 and IEEE float32, also under
WAVE_FORMAT_EXTENSIBLE.  No compiler, no global state: each call opens
its own file, so loader threads need no lock.
"""
from __future__ import annotations

import os
import struct
from typing import NamedTuple, Tuple

import numpy as np

_PCM, _FLOAT, _EXTENSIBLE = 1, 3, 0xFFFE
# (format tag, bits) -> (sample dtype, scale to [-1, 1))
_ENCODINGS = {
    (_PCM, 16): ("<i2", 1.0 / 32768.0),
    (_PCM, 24): (None, 1.0 / 8388608.0),
    (_PCM, 32): ("<i4", 1.0 / 2147483648.0),
    (_FLOAT, 32): ("<f4", None),
}


class WavInfo(NamedTuple):
    data_offset: int      # byte offset of the first sample
    num_frames: int
    channels: int
    sample_rate: int
    bits: int
    format: int           # 1 = PCM, 3 = IEEE float (the SubFormat when extensible)


def _read_header(fh) -> WavInfo:
    """Walk the RIFF chunks to the data chunk, as the C++ reader does."""
    head = fh.read(12)
    if len(head) != 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise IOError("not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = fh.read(8)
        if len(hdr) != 8:
            raise IOError("no data chunk")
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            body = fh.read(size)
            if size < 16 or len(body) != size:
                raise IOError("short fmt chunk")
            tag, channels, sr = struct.unpack("<HHI", body[:8])
            bits = struct.unpack("<H", body[14:16])[0]
            if tag == _EXTENSIBLE and size >= 40:
                tag = struct.unpack("<H", body[24:26])[0]   # SubFormat GUID's first 2 bytes
            fmt = (tag, channels, sr, bits)
        elif cid == b"data":
            if fmt is None:
                raise IOError("data chunk before fmt chunk")
            tag, channels, sr, bits = fmt
            frame_bytes = channels * bits // 8
            frames = size // frame_bytes if frame_bytes > 0 else 0
            return WavInfo(fh.tell(), frames, channels, sr, bits, tag)
        else:
            fh.seek(size + (size & 1), os.SEEK_CUR)         # word-aligned


def wav_info(path: str) -> Tuple[int, int, int]:
    """-> (num_frames, channels, sample_rate)."""
    with open(path, "rb") as fh:
        info = _read_header(fh)
    return info.num_frames, info.channels, info.sample_rate


def wav_read(path: str, start: int, num_frames: int, num_channels: int = 2) -> np.ndarray:
    """Positioned read -> planar float32 (num_channels, num_frames); zero-padded
    past the end, output channel c reads file channel min(c, channels - 1)."""
    with open(path, "rb") as fh:
        info = _read_header(fh)
        file_bytes = os.fstat(fh.fileno()).st_size
    enc = _ENCODINGS.get((info.format, info.bits))
    if enc is None:
        raise IOError(f"{path}: unsupported WAV encoding (format {info.format}, "
                      f"{info.bits} bits)")
    out = np.zeros((num_channels, num_frames), np.float32)
    width = info.bits // 8
    frame_bytes = info.channels * width
    first = max(start, 0)
    stored = min(info.num_frames, (file_bytes - info.data_offset) // frame_bytes)
    todo = min(num_frames, stored - first)
    if todo <= 0:
        return out
    raw = np.memmap(path, np.uint8, "r", offset=info.data_offset + first * frame_bytes,
                    shape=(todo, info.channels, width))
    dtype, scale = enc
    if dtype is None:   # PCM24: three little-endian bytes, sign from the top one
        b = raw.astype(np.int32)
        samples = ((b[..., 0] << 8) | (b[..., 1] << 16) | (b[..., 2] << 24)) >> 8
    else:
        samples = np.ascontiguousarray(raw).view(dtype)[..., 0]
    samples = samples.astype(np.float32)
    if scale is not None:
        samples *= np.float32(scale)
    src = np.minimum(np.arange(num_channels), info.channels - 1)
    out[:, :todo] = samples[:, src].T
    del raw
    return out


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Planar float32 (channels, frames) -> PCM16 WAV: clipped to [-1, 1],
    scaled by 32767 and truncated toward zero, as the C++ writer."""
    data = np.asarray(data, np.float32)
    if data.ndim != 2:
        raise ValueError(f"expected (channels, frames), got shape {data.shape}")
    channels, frames = data.shape
    pcm = (np.clip(data, -1.0, 1.0) * np.float32(32767.0)).astype("<i2")
    body = np.ascontiguousarray(pcm.T).tobytes()
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(body), b"WAVE",
                         b"fmt ", 16, _PCM, channels, sample_rate,
                         sample_rate * channels * 2, channels * 2, 16, b"data", len(body))
    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(body)
