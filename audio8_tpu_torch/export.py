"""Serialized-model export and load: ``torch.export`` inference artifacts.

Counterpart of ``audio8_tpu/export.py`` in PyTorch's idiom: the
acoustic forward (or the pooled utterance encoder's) is traced by
``torch.export`` into a versioned artifact directory that a server loads
and runs without the model code (``models``, ``nn``), the checkpoint
readers or the flags that built it. What the trace needs of the port is
its kernels, each a ``torch.library`` custom op with a fake
implementation (``audio8_tpu_torch.ops`` registers them); the loaded
program dispatches them by device like the live model does.

Artifact layout (a directory)::

    meta.json                 vocab, conv geometry, entry table, versions
    params.npz                the flat parameter list (p000000, ...):
                              the model's state dict in its order
    fwd_t<T>_<platform>.pt2   torch.export.save of
                              forward(flat_params, signal (b, T) f32,
                                      lengths (b,) int32)
                              -> (log_probs (b, T', V), frames (b,))

Design points, as in JAX:

- **Batch-polymorphic, time-static.** Each entry has a symbolic batch
  dimension and a FIXED sample count T; long audio rides
  ``serve.ChunkedTranscriber`` over an entry-sized window. A
  Mixture-of-Experts layer's capacity is a symbolic expression of B * T'
  (``nn/moe.py:capacity``), the live model's arithmetic, so an entry
  gives the live forward's log-probs at any batch size.
- **Parameters ride as call arguments,** not baked constants
  (``torch.func.functional_call`` over the flat list), so several
  entries share one ``params.npz``.
- **One entry per platform.** A trace bakes in the device of the
  factory ops it records (``torch.arange``, the masks), so ``cpu`` and
  ``cuda`` entries are traced apart, each from inputs on its device; a
  ``cuda`` entry needs the card. The loader runs the entries of the
  device it is given.
- ``meta.json`` records the torch version and the artifact schema
  version.

A transducer artifact (kind ``transducer``) holds three entries per
platform, by ``role``: ``encode`` (the encoder over one chunk, symbolic
batch, float32 features), ``decode_init`` (the predictor advanced once
on blank) and ``decode_frames``: the greedy search over ONE frame, with
its ``max_symbols_per_frame`` rounds (batch 1). ``torch.export`` unrolls
Python loops, so a window of 256 frames would trace into a graph of
tens of thousands of nodes; :class:`ExportedTransducer` loops the
one-frame program over a window's frames instead, keeping
``window_frames`` in ``meta`` and in the streamer's interface. Its
tokens equal the live search's (JAX exports the whole window).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

import audio8_tpu_torch.ops  # noqa: F401 - registers the a8t:: custom ops
from audio8_tpu_torch.utils import Offsets

ARTIFACT_VERSION = 1
PLATFORMS = ("cpu", "cuda")


class _Traced(torch.nn.Module):
    """``fn(state, *args)`` as a module with no parameters of its own:
    the model's weights enter as the flat list ``flat``, named ``names``,
    so the trace holds none of them."""

    def __init__(self, fn: Callable, names: Sequence[str]):
        super().__init__()
        self._fn, self._names = fn, list(names)

    def forward(self, flat: List[torch.Tensor], *args):
        return self._fn(dict(zip(self._names, flat)), *args)


class _Method(torch.nn.Module):
    """``model.<method>`` as a module's forward, so that
    ``torch.func.functional_call`` runs it on given weights (its state
    dict keys take the prefix ``model.``)."""

    def __init__(self, model: torch.nn.Module, method: str):
        super().__init__()
        self.model, self._method = model, method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self._method)(*args, **kwargs)


def state_fn(model: torch.nn.Module, head: Callable = lambda out: out,
             method: str = "forward", **kwargs) -> Callable:
    """``fn(state, *args) = head(model.<method>(*args, **kwargs))`` with
    ``model``'s weights taken from ``state`` (keyed as
    ``model.state_dict()``)."""
    wrapper = _Method(model, method)

    def fn(state, *args):
        state = {"model." + k: v for k, v in state.items()}
        return head(torch.func.functional_call(wrapper, state, args,
                                               kwargs))

    return fn


def export_program(fn: Callable, names: Sequence[str],
                   flat: Sequence[torch.Tensor], args: tuple,
                   dynamic_shapes=None) -> torch.export.ExportedProgram:
    """Trace ``fn(state, *args)`` under ``torch.no_grad()`` with the
    example ``args`` (``dynamic_shapes`` for them, the weights static)."""
    dyn = None
    if dynamic_shapes is not None:
        dyn = ([None] * len(flat), tuple(dynamic_shapes))
    with torch.no_grad():
        program = torch.export.export(_Traced(fn, names),
                                      (list(flat), *args),
                                      dynamic_shapes=dyn)
    program.example_inputs = None  # else torch.export.save keeps the weights
    return program


def export_forward(fn: Callable, names: Sequence[str],
                   flat: Sequence[torch.Tensor], t_samples: int,
                   device: torch.device) -> torch.export.ExportedProgram:
    """Trace ``fn(state, signal (b, t_samples) f32, lengths (b,) int32)``
    with a symbolic batch dimension, under ``torch.no_grad()``, from
    inputs on ``device`` (where ``flat`` lies)."""
    batch = torch.export.Dim("b", min=1, max=4096)
    # an example batch of 2: torch.export specializes a size of 1
    signal = torch.zeros((2, t_samples), dtype=torch.float32, device=device)
    lengths = torch.full((2,), t_samples, dtype=torch.int32, device=device)
    return export_program(fn, names, flat, (signal, lengths),
                          ({0: batch}, {0: batch}))


def save_artifact(out_dir: str, flat: Sequence[torch.Tensor], meta: dict,
                  entries: List[dict]) -> None:
    """Write the artifact directory: meta.json + params.npz + the
    ``entries`` (each ``{"t": int, "platform": str, "program":
    ExportedProgram}``) as .pt2 files."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = {f"p{i:06d}": x.detach().cpu().numpy()
              for i, x in enumerate(flat)}
    np.savez(os.path.join(out_dir, "params.npz"), **arrays)
    entry_meta = []
    for e in entries:
        name = (f"fwd_t{e['t']}_{e['platform']}.pt2" if "t" in e
                else f"{e['role']}_{e['platform']}.pt2")
        torch.export.save(e["program"], os.path.join(out_dir, name))
        entry_meta.append({k: e[k] for k in ("role", "t") if k in e}
                          | {"platform": e["platform"], "file": name})
    meta = dict(meta)
    meta["version"] = ARTIFACT_VERSION
    meta["torch_version"] = torch.__version__
    meta["entries"] = entry_meta
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


class _ArtifactBase:
    """Shared artifact loading: meta.json + schema-version check + the
    flat params.npz list on ``device``. Subclasses load their entries."""

    def __init__(self, path: str, device: torch.device | str = "cpu"):
        self.path = path
        self.device = torch.device(device)
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("version", 0) > ARTIFACT_VERSION:
            raise ValueError(
                f"artifact schema v{self.meta['version']} is newer than "
                f"this loader (v{ARTIFACT_VERSION})")
        with np.load(os.path.join(path, "params.npz")) as z:
            self._params = [torch.from_numpy(z[k]).to(self.device)
                            for k in sorted(z.files)]

    def _load(self, entry: dict):
        return torch.export.load(os.path.join(self.path,
                                              entry["file"])).module()

    @property
    def kind(self) -> str:
        return self.meta.get("kind", "ctc")

    @property
    def conv_features(self):
        return [tuple(f) for f in self.meta["conv_features"]]

    @property
    def sample_rate(self) -> int:
        return int(self.meta.get("sample_rate", 16_000))


class ExportedAcoustic(_ArtifactBase):
    """A loaded artifact: ``forward(signal, lengths)`` with the entry
    table's shape discipline, plus the metadata serving needs.

    ``forward`` takes tensors on the loader's device (or arrays), pads
    the time axis up to the smallest entry that fits (any batch size
    runs) and returns ``(log_probs, frames)`` as the live
    ``cli/transcribe.load_acoustic`` forward does, so the
    ``ChunkedTranscriber``, ``StreamingTranscriber`` and
    ``MicroBatcher`` take it unchanged. As in JAX, the valid-frame count
    is a function of the PADDED length, so outputs equal a live eval's
    only where both pad to the same sizes (``cli.test --exported`` pins
    the dataset's length grid to the entry table)."""

    def __init__(self, path: str, device: torch.device | str = "cpu"):
        super().__init__(path, device)
        platform = self.device.type
        fns: Dict[int, Callable] = {}
        for e in sorted(self.meta["entries"], key=lambda e: e["t"]):
            if e.get("platform") == platform:
                fns[int(e["t"])] = self._load(e)
        if not fns:
            raise ValueError(
                f"artifact {path} has no entries for {platform} (it has "
                f"{sorted({e.get('platform') for e in self.meta['entries']})}"
                f"); re-export with --platforms {platform}")
        self._fns = fns
        self._sizes = sorted(fns)

    @property
    def vocab(self) -> List[str]:
        return list(self.meta["vocab"])

    @property
    def max_samples(self) -> int:
        return self._sizes[-1]

    @property
    def entry_sizes(self) -> List[int]:
        return list(self._sizes)

    def entry_samples(self, requested: int = 0) -> int:
        """The entry size serving should window on: the smallest entry
        >= ``requested`` (or the largest when none fit / unspecified)."""
        for t in self._sizes:
            if t >= requested > 0:
                return t
        return self._sizes[-1]

    @torch.no_grad()
    def forward(self, signal, lengths):
        signal = torch.as_tensor(signal, dtype=torch.float32,
                                 device=self.device)
        t = signal.shape[-1]
        fit = [s for s in self._sizes if s >= t]
        if not fit:
            raise ValueError(
                f"input of {t} samples exceeds the largest exported "
                f"shape ({self._sizes[-1]}); window long audio with "
                f"--chunk_seconds (ChunkedTranscriber) or re-export "
                f"with a larger --seconds")
        tt = fit[0]
        if tt != t:
            signal = torch.nn.functional.pad(signal, (0, tt - t))
        lengths = torch.as_tensor(lengths, device=self.device).to(
            torch.int32)
        return self._fns[tt](self._params, signal.contiguous(), lengths)


class ExportedEmbedder(ExportedAcoustic):
    """A loaded utterance-embedding artifact (kind 'embed'): the same
    entry-table shape discipline as the CTC artifact, but the forward
    returns (B, D) L2-normalized embeddings (no vocab, no frames).
    ``reduction_type`` records the pooling baked at export."""

    @property
    def reduction_type(self) -> str:
        return self.meta.get("reduction_type", "mean")


class ExportedTransducer(_ArtifactBase):
    """A loaded RNN-T artifact: ``encode``, ``decode_init`` and
    ``decode_frames`` with the interface of
    ``cli/transcribe.py:load_transducer_stream``, so a
    ``serve.TransducerStreamer`` takes them unchanged (chunk
    ``chunk_samples`` for the encoder, ``window_frames`` per decode
    window, ``max_output_len`` labels). ``decode_frames`` runs the
    exported one-frame search over the window's live frames."""

    def __init__(self, path: str, device: torch.device | str = "cpu"):
        Offsets.remap_fairseq_ctc()  # PAD and blank in the CTC layout
        super().__init__(path, device)
        platform = self.device.type
        entries = [e for e in self.meta["entries"]
                   if e.get("platform") == platform]
        fns = {e["role"]: self._load(e) for e in entries if "role" in e}
        missing = {"encode", "decode_init", "decode_frames"} - set(fns)
        if missing:
            raise ValueError(f"artifact {path} has no {sorted(missing)} "
                             f"entries for {platform}")
        self._encode, self._init, self._frame = (
            fns["encode"], fns["decode_init"], fns["decode_frames"])
        self.chunk_samples = int(next(e["t"] for e in entries
                                      if e["role"] == "encode"))
        self.window_frames = int(self.meta["window_frames"])
        self.max_output_len = int(self.meta["max_output_len"])

    @property
    def vocab(self) -> List[str]:
        return list(self.meta["vocab"])

    @torch.no_grad()
    def encode(self, signal, lengths):
        signal = torch.as_tensor(signal, dtype=torch.float32,
                                 device=self.device)
        t = signal.shape[-1]
        if t > self.chunk_samples:
            raise ValueError(
                f"encode window of {t} samples exceeds the exported chunk "
                f"({self.chunk_samples}); the TransducerStreamer must "
                "window on chunk_samples")
        if t < self.chunk_samples:
            signal = torch.nn.functional.pad(signal,
                                             (0, self.chunk_samples - t))
        lengths = torch.as_tensor(lengths, device=self.device).to(
            torch.int32)
        return self._encode(self._params, signal.contiguous(), lengths)

    @torch.no_grad()
    def decode_init(self):
        return self._init(self._params)

    @torch.no_grad()
    def decode_frames(self, enc, n_frames, tokens, n, pred_out, carry):
        """The window's frames one by one; frames at or past
        ``n_frames`` are inert, so the loop stops there."""
        live = min(int(n_frames.reshape(-1)[0]), enc.shape[1])
        one = torch.ones((1,), dtype=torch.int32, device=self.device)
        state = (tokens, n, pred_out, carry)
        for t in range(live):
            state = self._frame(self._params, enc[:, t:t + 1].contiguous(),
                                one, *state)
        return state


def artifact_kind(path: str) -> str:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f).get("kind", "ctc")


def load_artifact(path: str, device: torch.device | str = "cpu"):
    """Load an artifact by its recorded kind onto ``device``:
    ``ExportedAcoustic`` (kind 'ctc'), ``ExportedEmbedder`` ('embed') or
    ``ExportedTransducer`` ('transducer')."""
    kind = artifact_kind(path)
    if kind == "transducer":
        return ExportedTransducer(path, device)
    if kind == "ctc":
        return ExportedAcoustic(path, device)
    if kind == "embed":
        return ExportedEmbedder(path, device)
    raise ValueError(f"unknown artifact kind {kind!r} in {path}")
