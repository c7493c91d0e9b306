"""Host audio IO of the port (``audio8_tpu/data/audio.py``).

WAV goes through scipy's reader; NIST SPHERE (pcm, mu-law) and AIFF/AIFC
are read in numpy; FLAC is decoded by the port's host library
(``csrc/flac.cc``, built with ``g++`` at first use). Other formats go to
python-soundfile when it is installed.
"""
from __future__ import annotations

import struct

import numpy as np

from audio8_tpu_torch.csrc import native

def _pcm_to_float(data: np.ndarray) -> np.ndarray:
    """soundfile's default float conversion: ints scale to [-1, 1)."""
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    if data.dtype == np.int8:
        return data.astype(np.float32) / 128.0
    return data.astype(np.float32)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 array, sample_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    return _pcm_to_float(data), sr


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Read a FLAC file -> (float32 array, sample_rate); integer samples
    scale by 2^(bits - 1), as the JAX package's reader does."""
    data, sr, bps = native.flac_read(path)
    scale = float(1 << (bps - 1)) if bps > 1 else 1.0
    return np.asarray(data, np.float32) / scale, sr


_ULAW_BIAS = 0x84


def _ulaw_decode(u: np.ndarray) -> np.ndarray:
    """G.711 mu-law byte -> int16 linear PCM."""
    u = (~u.astype(np.int32)) & 0xFF
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    sample = (((mantissa << 3) + _ULAW_BIAS) << exponent) - _ULAW_BIAS
    return np.where(sign, -sample, sample).astype(np.int16)


def _native_order(data: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(data).astype(data.dtype.newbyteorder("="))


def read_sphere(path: str) -> tuple[np.ndarray, int]:
    """NIST SPHERE (.sph): ASCII header + pcm or mu-law payload.
    Shorten-compressed payloads raise."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"NIST_1A"):
            raise ValueError(f"{path!r}: not a NIST SPHERE file")
        header_size = int(f.readline().strip())
        f.seek(0)
        header = f.read(header_size).decode("ascii", "replace")
        fields = {}
        for line in header.splitlines()[2:]:
            parts = line.split(maxsplit=2)
            if len(parts) == 3 and parts[1].startswith("-"):
                fields[parts[0]] = parts[2]
            if line.strip() == "end_head":
                break
        sr = int(fields.get("sample_rate", 16000))
        n_channels = int(fields.get("channel_count", 1))
        sample_bytes = int(fields.get("sample_n_bytes", 2))
        coding = fields.get("sample_coding", "pcm")
        byte_fmt = fields.get("sample_byte_format", "01")
        if "embedded-shorten" in coding or coding.startswith("shorten"):
            raise ValueError(
                f"{path!r}: shorten-compressed SPHERE is not supported; "
                "convert with `sph2pipe -p` first")
        f.seek(header_size)
        raw = f.read()
    if "ulaw" in coding:
        data = _ulaw_decode(np.frombuffer(raw, np.uint8))
    else:
        widths = {1: np.int8, 2: np.int16, 4: np.int32}
        if sample_bytes not in widths:
            raise ValueError(f"{path!r}: unsupported SPHERE sample_n_bytes="
                             f"{sample_bytes} (supported: 1, 2, 4)")
        dt = np.dtype(widths[sample_bytes])
        dt = dt.newbyteorder("<" if byte_fmt == "01" else ">")
        data = np.frombuffer(raw[: (len(raw) // dt.itemsize) * dt.itemsize],
                             dt)
    if n_channels > 1:
        data = data.reshape(-1, n_channels)
    return _pcm_to_float(_native_order(data)), sr


def _float80_to_int(b: bytes) -> int:
    """IEEE 754 80-bit extended float -> int (AIFF sample rates)."""
    exponent = ((b[0] & 0x7F) << 8) | b[1]
    mantissa = int.from_bytes(b[2:10], "big")
    if exponent == 0 and mantissa == 0:
        return 0
    val = mantissa * 2.0 ** (exponent - 16383 - 63)
    return int(round(-val if b[0] & 0x80 else val))


def read_aiff(path: str) -> tuple[np.ndarray, int]:
    """AIFF/AIFC (big-endian PCM; 'sowt' is little-endian)."""
    with open(path, "rb") as f:
        form, _, kind = struct.unpack(">4sI4s", f.read(12))
        if form != b"FORM" or kind not in (b"AIFF", b"AIFC"):
            raise ValueError(f"{path!r}: not an AIFF file")
        comm = ssnd = None
        compression = b"NONE"
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack(">4sI", hdr)
            body = f.read(size + (size & 1))[:size]
            if cid == b"COMM":
                n_channels, _, bits = struct.unpack(">hIh", body[:8])
                sr = _float80_to_int(body[8:18])
                if kind == b"AIFC" and len(body) >= 22:
                    compression = body[18:22]
                comm = (n_channels, bits)
            elif cid == b"SSND":
                offset, _ = struct.unpack(">II", body[:8])
                ssnd = body[8 + offset:]
        if comm is None or ssnd is None:
            raise ValueError(f"{path!r}: missing COMM/SSND chunk")
    if compression not in (b"NONE", b"sowt", b"twos"):
        raise ValueError(
            f"{path!r}: compressed AIFC ({compression!r}) is not supported")
    n_channels, bits = comm
    order = "<" if compression == b"sowt" else ">"
    if bits <= 8:
        data = np.frombuffer(ssnd, np.int8).astype(np.int16) * 256
    elif bits <= 16:
        data = np.frombuffer(ssnd, np.dtype(np.int16).newbyteorder(order))
    elif bits <= 24:
        b3 = np.frombuffer(ssnd[: len(ssnd) // 3 * 3], np.uint8).reshape(-1, 3)
        if order == "<":
            b3 = b3[:, ::-1]
        data = ((b3[:, 0].astype(np.int32) << 24)
                | (b3[:, 1].astype(np.int32) << 16)
                | (b3[:, 2].astype(np.int32) << 8)) >> 8
        if n_channels > 1:
            data = data.reshape(-1, n_channels)
        return data.astype(np.float32) / float(1 << 23), sr
    else:
        data = np.frombuffer(ssnd, np.dtype(np.int32).newbyteorder(order))
    if n_channels > 1:
        data = data.reshape(-1, n_channels)
    return _pcm_to_float(_native_order(data)), sr


SUPPORTED_FORMATS = (".wav", ".flac", ".sph", ".aif", ".aiff", ".aifc")


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Format-dispatched decode -> (float32 array, sample_rate)."""
    low = path.lower()
    if low.endswith(".wav"):
        return read_wav(path)
    if low.endswith(".flac"):
        return read_flac(path)
    if low.endswith(".sph"):
        return read_sphere(path)
    if low.endswith((".aif", ".aiff", ".aifc")):
        return read_aiff(path)
    try:
        import soundfile  # type: ignore
    except ImportError:
        raise ValueError(
            f"unsupported audio format for {path!r}: built-in decoders "
            f"cover {', '.join(SUPPORTED_FORMATS)}; install python-"
            "soundfile (libsndfile) for other formats") from None
    data, sr = soundfile.read(path, dtype="float32")
    return data, sr


class SoundfileAudioReader:
    """File -> float32 mono waveform, optional truncation."""

    def transform(self, audio: np.ndarray) -> np.ndarray:
        return audio.astype(np.float32)

    def read(self, file: str, max_length: int = -1) -> np.ndarray:
        wav, _ = read_audio(file)
        if wav.ndim > 1:
            wav = wav[:, 0]
        wav = self.transform(wav)
        if max_length > 0:
            return wav[:max_length]
        return wav


class AudioResampleReader(SoundfileAudioReader):
    """FFT resample by the target/input sample-rate ratio."""

    def __init__(self, sample_factor: float):
        self.sample_factor = sample_factor

    def transform(self, wav: np.ndarray) -> np.ndarray:
        import scipy.signal

        num = int(len(wav) * self.sample_factor)
        return scipy.signal.resample(wav, num).astype(np.float32)


class NoiseMixer:
    """Additive noise at a random SNR (``audio8_tpu/data/audio.py``'s
    ``NoiseMixer``, MUSAN-style). ``source`` is an audio manifest TSV
    (the audio root, then ``file\\tnum_samples`` rows) or a directory of
    audio files. Each call mixes one noise clip chosen by ``rng``, looped
    or cropped to the utterance's length, at an SNR drawn uniformly from
    ``snr_db``, with probability ``prob``; the length is kept. The draws
    and the arithmetic are the JAX package's, so the same ``rng`` gives
    the same samples."""

    def __init__(self, source: str, snr_db=(5.0, 20.0), prob: float = 1.0):
        import os

        self.snr_db = (float(snr_db[0]), float(snr_db[1]))
        self.prob = float(prob)
        self._reader = SoundfileAudioReader()
        if os.path.isdir(source):
            self.files = sorted(
                os.path.join(source, f) for f in os.listdir(source)
                if f.lower().endswith(SUPPORTED_FORMATS))
        else:
            with open(source) as f:
                directory = f.readline().strip()
                self.files = [os.path.join(directory, ln.split("\t")[0])
                              for ln in f if ln.strip()]
        if not self.files:
            raise ValueError(f"no noise files found in {source!r}")

    def __call__(self, wav: np.ndarray, rng) -> np.ndarray:
        if self.prob < 1.0 and rng.random() > self.prob:
            return wav
        noise = np.asarray(
            self._reader.read(self.files[int(rng.integers(len(self.files)))]),
            np.float32).squeeze()
        if noise.size == 0:
            return wav
        if len(noise) < len(wav):
            noise = np.tile(noise, -(-len(wav) // len(noise)))
        if len(noise) > len(wav):
            start = int(rng.integers(len(noise) - len(wav) + 1))
            noise = noise[start:start + len(wav)]
        rms_s = float(np.sqrt(np.mean(np.square(wav)))) or 1e-8
        rms_n = float(np.sqrt(np.mean(np.square(noise))))
        if rms_n < 1e-8:
            return wav
        snr = float(rng.uniform(*self.snr_db))
        scale = rms_s / (rms_n * 10.0 ** (snr / 20.0))
        return (wav + scale * noise).astype(np.float32)


def speed_perturb_wav(wav: np.ndarray, factor: float) -> np.ndarray:
    """``wav`` played at ``factor`` times its speed (its duration divided
    by ``factor``): a polyphase resample at the factor's rational
    approximation with denominators up to 100, the Kaldi/fairseq
    speed-perturbation primitive."""
    from fractions import Fraction

    import scipy.signal

    frac = Fraction(factor).limit_denominator(100)
    if frac.numerator == frac.denominator:
        return np.asarray(wav, np.float32)
    out = scipy.signal.resample_poly(
        np.asarray(wav, np.float32), frac.denominator, frac.numerator)
    return out.astype(np.float32)
