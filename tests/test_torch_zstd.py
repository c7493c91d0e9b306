"""The port's zstd decoder, CRC32C and XXH64 (``csrc/zstd.cc`` through
``csrc/native.py``), held to the ``zstandard`` package, which only this
test imports, on the CPU.

* Every input (empty, 1 byte, zeros, random bytes, text, f32 and bf16
  arrays, more than 128 KiB so a frame has several blocks) compressed
  by ``zstandard`` at levels -5, 1, 3, 9 and 19, with and without the
  content checksum and the content size, decodes to itself. Several
  frames in a row decode to their concatenation, a skippable frame
  decodes to nothing. A frame written in streaming mode (no content
  size, a window descriptor) decodes too.
* CRC32C and XXH64 match their published vectors and zstd's own frame
  checksums.
* A corrupt frame raises: a flipped bit in a compressed block, a wrong
  content checksum, a truncated frame, a frame that needs a dictionary,
  bytes that are not zstd.
* Without ``g++`` the first decode raises: there is no fallback to a
  package, even where one is installed.
"""
import shutil
import struct

import numpy as np
import pytest
import zstandard

from audio8_tpu_torch.csrc import build as port_build
from audio8_tpu_torch.csrc import native
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


def _inputs():
    rng = np.random.default_rng(0)
    text = (b"the quick brown fox jumps over the lazy dog; " * 50
            + bytes(range(256)) * 4)
    f32 = rng.standard_normal(20_000).astype(np.float32)
    bf16 = (f32.view(np.uint32) >> 16).astype(np.uint16)
    return {
        "empty": b"",
        "one": b"x",
        "zeros": bytes(70_000),
        "random": rng.bytes(3_000),
        "text": text,
        "f32": f32.tobytes(),
        "bf16": bf16.tobytes(),
        "multiblock": (text * 60)[:300_000] + rng.bytes(100_000),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
def test_decodes_what_zstandard_encodes(level, checksum, content_size):
    cctx = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size)
    for name, data in INPUTS.items():
        frame = cctx.compress(data)
        assert native.zstd_decompress(frame) == data, name


def test_streamed_frames_and_several_frames():
    data = INPUTS["multiblock"]
    streamed = zstandard.ZstdCompressor(level=3).compressobj()
    frame = streamed.compress(data) + streamed.flush()
    assert native.zstd_decompress(frame) == data
    a = zstandard.ZstdCompressor(level=1).compress(b"abc" * 100)
    b = zstandard.ZstdCompressor(level=9).compress(INPUTS["text"])
    skip = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    assert native.zstd_decompress(a + skip + b) == b"abc" * 100 \
        + INPUTS["text"]


def test_checksums_match_known_vectors():
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"") == 0
    assert native.crc32c(b"6789", native.crc32c(b"12345")) == 0xE3069283
    assert native.xxh64(b"") == 0xEF46DB3751D8E999
    assert native.xxh64(b"abc") == 0x44BC2CF5AD770999
    cctx = zstandard.ZstdCompressor(write_checksum=True)
    for data in INPUTS.values():  # zstd's checksum: XXH64's low 32 bits
        frame = cctx.compress(data)
        assert struct.unpack("<I", frame[-4:])[0] == \
            native.xxh64(data) & 0xFFFFFFFF


def test_corrupt_frames_raise():
    text = INPUTS["text"]
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(text))
    bad = bytearray(frame)
    bad[len(bad) // 2] ^= 0x55
    with pytest.raises(ValueError, match="zstd"):
        native.zstd_decompress(bytes(bad))
    bad = bytearray(frame)
    bad[-1] ^= 1  # the content checksum
    with pytest.raises(ValueError, match="checksum"):
        native.zstd_decompress(bytes(bad))
    with pytest.raises(ValueError, match="zstd"):
        native.zstd_decompress(bytes(frame[:len(frame) // 2]))
    with pytest.raises(ValueError, match="not a zstd frame"):
        native.zstd_decompress(b"not zstd at all")
    streamed = zstandard.ZstdCompressor().compressobj()
    plain = streamed.compress(text) + streamed.flush()
    assert plain[4] & 0x23 == 0  # a window descriptor, no dictionary ID
    with_dict = plain[:4] + bytes([plain[4] | 1]) + plain[5:6] + b"\x07" \
        + plain[6:]  # the same frame naming dictionary 7
    with pytest.raises(ValueError, match="dictionary"):
        native.zstd_decompress(with_dict)


def test_no_fallback_when_the_library_cannot_be_built(monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(port_build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_loaded", None)
    frame = zstandard.ZstdCompressor().compress(b"abc")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.zstd_decompress(frame)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.crc32c(b"abc")
