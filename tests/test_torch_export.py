"""``torch.export`` artifacts of the port (``export.py``, ``cli.export``)
against the port's live model and the JAX package, on the committed
fairseq golden checkpoint (``tests/fixtures/fairseq_golden``; its
2-layer, 32-channel extractor, whose k3s2 layer runs the
``a8t::conv_k3s2`` op, given to both packages' configs).
``tests/test_torch_export_cli.py`` holds the four ``--exported``
decoding surfaces to JAX's.

* The round trip (``cli.export --device cpu --platforms cpu``, then
  ``load_artifact``) equals the port's live forward bitwise, on a full
  batch and on a shorter one padded up, and stays within 1e-5 of JAX's
  live forward; int8 (``--quantize int8``) equals the port's live int8
  forward (int8 is held to JAX layer by layer in
  ``test_torch_quant.py``, not end to end).
* The loader pads up to the smallest entry, rejects oversize input with
  JAX's message, runs the entries of its device, checks the schema
  version, and runs with the port's ``models`` and ``nn`` blocked;
  ``meta.json`` has JAX's keys with ``torch_version`` for
  ``jax_version``.
* Every preset exports at a tiny size and equals its live forward, and
  the position tables a trace builds stay out of the live caches;
  ``--transducer`` refuses what JAX's refuses, and a transducer artifact
  without its three roles does not load (``test_torch_transducer_cli.py``
  exports and runs one); every
  JAX flag of ``cli.export`` parses with its default but ``--platforms``
  (``cpu cuda`` for JAX's ``cpu tpu``), and ``tpu`` is refused.
"""
import functools
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import audio8_tpu.cli.export as jax_export_cli
import audio8_tpu.cli.transcribe as jax_transcribe
import audio8_tpu.config as jax_config
import audio8_tpu_torch.cli.embed as embed
import audio8_tpu_torch.cli.test as test_cli
import audio8_tpu_torch.cli.transcribe as transcribe
from audio8_tpu_torch import export as E
from audio8_tpu_torch.cli import export as export_cli
from audio8_tpu_torch.cli.common import MODEL_PRESETS, _PRESET_BASE_DEFAULTS
from audio8_tpu_torch.config import AcousticConfig, PooledConfig
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_flags import captured_parser, flags
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_transcribe_cli import FIX, LETTERS, SIZE

cap_torch_threads()

SR = 16_000
ENTRY = SR  # the artifacts' one window
TOL = 1e-5
with open(os.path.join(FIX, "MANIFEST.json")) as _f:
    GEOMETRY = tuple(tuple(b) for b in json.load(_f)["geometry"]["fx"])


def _patch_geometry(mp):
    """The golden checkpoints' extractor in every config the CLIs build."""
    import audio8_tpu.cli.test as jax_test

    for module, cls in ((jax_transcribe, jax_config.AcousticConfig),
                        (transcribe, AcousticConfig),
                        (test_cli, AcousticConfig),
                        (jax_test, jax_config.AcousticConfig),
                        (embed, PooledConfig)):
        mp.setattr(module, cls.__name__, functools.partial(
            cls, custom_conv_features=GEOMETRY))
    # the JAX embedder imports its config inside build_embedder
    mp.setattr(jax_config, "PooledConfig", functools.partial(
        jax_config.PooledConfig, custom_conv_features=GEOMETRY))


@pytest.fixture(autouse=True)
def _golden_geometry(monkeypatch):
    _patch_geometry(monkeypatch)
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def _write_wav(path, wav):
    wavfile.write(str(path), SR, (wav * 32767).astype(np.int16))


def write_dict(path) -> str:
    with open(path, "w") as f:
        f.writelines(f"{c} {100 - i}\n" for i, c in enumerate(LETTERS))
    return str(path)


def export_args(checkpoint: str, dict_file: str, out: str, *extra: str):
    return ["--checkpoint", checkpoint, "--dict_file", dict_file,
            "--output", out, "--seconds", "1", *SIZE, *extra]


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """The golden CTC checkpoint exported by the port at one 1 s entry for
    the CPU, loaded; and JAX's ``meta.json`` of the same export (its
    lowering stubbed out: only the metadata is compared here)."""
    tmp = tmp_path_factory.mktemp("export")
    dict_file = write_dict(tmp / "dict.ltr.txt")
    ckpt = os.path.join(FIX, "ctc_tiny.pt")
    with pytest.MonkeyPatch.context() as mp:
        _patch_geometry(mp)
        port = export_cli.main(export_args(ckpt, dict_file, str(tmp / "port"),
                                           "--device", "cpu", "--platforms",
                                           "cpu"))
        mp.setattr(jax_export_cli, "export_forward", lambda *a, **k: b"")
        theirs = jax_export_cli.main(export_args(
            ckpt, dict_file, str(tmp / "jax"), "--platforms", "cpu",
            "--lane_align", "false"))
    return dict(port=port, jax=theirs, dict_file=dict_file, root=tmp,
                loaded=E.load_artifact(port, "cpu"))


def _live(quantize="none"):
    """The port's live model of the golden checkpoint, on the CPU."""
    from audio8_tpu_torch.models.convert import load_fairseq_ctc
    from audio8_tpu_torch.ops.quant import quantize_model_params

    cfg = AcousticConfig(num_labels=len(LETTERS) + 4, d_model=64,
                         num_heads=4, num_layers=2, d_ff=256,
                         timestep_masking=0.0, channel_masking=0.0,
                         custom_conv_features=GEOMETRY)
    model = Wav2Vec2AcousticModel(cfg)
    model.load_state_dict(load_fairseq_ctc(os.path.join(FIX, "ctc_tiny.pt")),
                          strict=True)
    if quantize == "int8":
        quantize_model_params(model)
    return model.eval()


def _batch(seed=0, b=3, t=ENTRY):
    rng = np.random.default_rng(seed)
    sig = (rng.normal(size=(b, t)) * 0.2).astype(np.float32)
    lens = np.array([t, t - 9_000, 1_500][:b], np.int32)
    return sig, lens


def _valid(lp, frames):
    return [lp[i, :int(frames[i])] for i in range(len(frames))]


def test_round_trip_equals_live_bitwise_and_jax(art):
    loaded = art["loaded"]
    model = _live()
    sig, lens = _batch()
    lp, frames = loaded.forward(torch.from_numpy(sig), torch.from_numpy(lens))
    with torch.no_grad():
        want, mask = model(torch.from_numpy(sig), torch.from_numpy(lens))
    assert torch.equal(lp, want) and torch.equal(frames, mask.sum(-1))
    # a shorter batch pads up to the entry
    short, short_lens = sig[:2, :12_000], np.array([12_000, 5_000], np.int32)
    lp2, frames2 = loaded.forward(short, short_lens)
    with torch.no_grad():
        want2, mask2 = model(torch.nn.functional.pad(
            torch.from_numpy(short), (0, ENTRY - 12_000)),
            torch.from_numpy(short_lens))
    assert torch.equal(lp2, want2) and torch.equal(frames2, mask2.sum(-1))
    # JAX's live forward on the same weights
    args = jax_transcribe.parse_args(
        ["x.wav", "--checkpoint", os.path.join(FIX, "ctc_tiny.pt"),
         "--dict_file", art["dict_file"], "--lane_align", "false", *SIZE])
    with pytest.MonkeyPatch.context() as mp:
        _patch_geometry(mp)
        _, jax_forward, *_ = jax_transcribe.load_acoustic(args)
    jlp, jframes = jax_forward(jnp.asarray(sig), jnp.asarray(lens))
    assert np.array_equal(np.asarray(jframes), frames.numpy())
    for a, b in zip(_valid(lp.numpy(), frames), _valid(np.asarray(jlp),
                                                       frames)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_int8_export_equals_live_int8(art, tmp_path):
    out = export_cli.main(export_args(
        os.path.join(FIX, "ctc_tiny.pt"), art["dict_file"],
        str(tmp_path / "int8"), "--quantize", "int8", "--device", "cpu",
        "--platforms", "cpu"))
    loaded = E.load_artifact(out, "cpu")
    assert loaded.meta["quantize"] == "int8"
    model = _live("int8")
    sig, lens = _batch(1)
    lp, frames = loaded.forward(sig, lens)
    with torch.no_grad():
        want, mask = model(torch.from_numpy(sig), torch.from_numpy(lens))
    assert torch.equal(lp, want) and torch.equal(frames, mask.sum(-1))
    # int8 codes are integers in the flat list, the scales f32
    with np.load(os.path.join(out, "params.npz")) as z:
        assert {z[k].dtype for k in z.files} == {np.dtype(np.float32),
                                                 np.dtype(np.int8)}


def test_loader_pads_up_and_rejects_oversize(art):
    loaded = art["loaded"]
    assert loaded.entry_sizes == [ENTRY] and loaded.max_samples == ENTRY
    assert loaded.entry_samples(10) == ENTRY == loaded.entry_samples(10**9)
    lp, frames = loaded.forward(np.zeros((1, 100), np.float32), [100])
    assert lp.shape[1] == loaded.forward(np.zeros((1, ENTRY), np.float32),
                                         [ENTRY])[0].shape[1]
    with pytest.raises(ValueError, match="exceeds the largest exported "
                                         "shape"):
        loaded.forward(np.zeros((1, ENTRY + 1), np.float32), [ENTRY + 1])
    # JAX's loader says the same (its entries never run: it raises first)
    from audio8_tpu.export import ExportedAcoustic as JaxExported

    jax_loaded = object.__new__(JaxExported)
    jax_loaded._sizes = [ENTRY]
    with pytest.raises(ValueError) as theirs:
        jax_loaded.forward(np.zeros((1, ENTRY + 1), np.float32), [ENTRY + 1])
    with pytest.raises(ValueError) as mine:
        loaded.forward(np.zeros((1, ENTRY + 1), np.float32), [ENTRY + 1])
    assert str(mine.value) == str(theirs.value)



def test_loader_takes_the_entries_of_its_device(art, tmp_path):
    """An artifact traced for the card only has nothing to run here."""
    import shutil

    card_only = tmp_path / "card"
    shutil.copytree(art["port"], card_only)
    meta = json.loads((card_only / "meta.json").read_text())
    for e in meta["entries"]:
        e["platform"] = "cuda"
    (card_only / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="no entries for cpu .* "
                                         "--platforms cpu"):
        E.load_artifact(str(card_only), "cpu")


def test_meta_keys_equal_jax_and_the_schema_version_is_checked(
        art, tmp_path):
    with open(os.path.join(art["port"], "meta.json")) as f:
        mine = json.load(f)
    with open(os.path.join(art["jax"], "meta.json")) as f:
        theirs = json.load(f)
    assert set(mine) == set(theirs) - {"jax_version"} | {"torch_version"}
    assert mine["version"] == E.ARTIFACT_VERSION == 1
    assert mine["torch_version"] == torch.__version__
    for key in ("kind", "vocab", "conv_features", "sample_rate", "d_model",
                "num_layers", "quantize", "bf16"):
        assert mine[key] == theirs[key], key
    assert mine["platforms"] == ["cpu"]
    assert [(e["t"], e["platform"]) for e in mine["entries"]] == [
        (ENTRY, "cpu")]
    newer = tmp_path / "newer"
    newer.mkdir()
    (newer / "meta.json").write_text(json.dumps(dict(mine, version=2)))
    with pytest.raises(ValueError, match="newer than this loader"):
        E.load_artifact(str(newer))


def test_loader_runs_without_the_model_code(art):
    """A process with the port's ``models`` and ``nn`` (and jax) blocked
    loads the artifact and gives the in-process log-probs."""
    sig, lens = _batch(2)
    want = art["loaded"].forward(sig, lens)[0]
    code = (
        "import sys\n"
        "for m in ('audio8_tpu_torch.models', 'audio8_tpu_torch.nn',\n"
        "          'jax', 'audio8_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import torch\n"
        f"torch.set_num_threads({torch.get_num_threads()})\n"
        "from audio8_tpu_torch.export import load_artifact\n"
        f"art = load_artifact({art['port']!r}, 'cpu')\n"
        "rng = np.random.default_rng(2)\n"
        f"sig = (rng.normal(size=(3, {ENTRY})) * 0.2).astype(np.float32)\n"
        f"lp, frames = art.forward(sig, {lens.tolist()!r})\n"
        "np.save(sys.argv[1], lp.numpy())\n"
        "assert not any(k.startswith(('audio8_tpu_torch.models',\n"
        "                             'audio8_tpu_torch.nn'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n")
    out = os.path.join(art["root"], "no_model.npy")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code, out], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    assert np.array_equal(np.load(out), want.numpy())


PRESETS = sorted(MODEL_PRESETS)


@pytest.mark.parametrize("preset", PRESETS)
def test_every_preset_exports_and_equals_its_live_forward(preset):
    topology = {k: MODEL_PRESETS[preset].get(k, v)
                for k, v in _PRESET_BASE_DEFAULTS.items()
                if k not in ("d_model", "d_ff", "num_heads", "num_layers",
                             "final_dim")}
    cfg = AcousticConfig(num_labels=8, d_model=64, num_heads=4,
                         num_layers=2, d_ff=128, timestep_masking=0.0,
                         channel_masking=0.0, custom_conv_features=GEOMETRY,
                         **topology)
    model = Wav2Vec2AcousticModel(
        cfg, generator=torch.Generator().manual_seed(0)).eval()
    state = model.state_dict()
    program = E.export_forward(
        E.state_fn(model, lambda out: (out[0], out[1].sum(-1))),
        list(state), list(state.values()), SR, torch.device("cpu"))
    sig, lens = _batch(3, t=SR)
    lens = np.array([SR, 9_000, 400], np.int32)
    lp, frames = program.module()(list(state.values()), torch.from_numpy(sig),
                                  torch.from_numpy(lens))
    with torch.no_grad():
        want, mask = model(torch.from_numpy(sig), torch.from_numpy(lens))
    assert torch.equal(lp, want) and torch.equal(frames, mask.sum(-1))
    # the position tables the trace built stay out of the live caches
    with torch.no_grad():
        again, _ = model(torch.from_numpy(sig), torch.from_numpy(lens))
    assert torch.equal(again, want)


def test_transducer_export_and_artifacts_raise_naming_item_7(art, tmp_path):
    """The transducer's export is ported (``test_torch_transducer_cli.py``
    runs it): what still refuses is what JAX refuses. ``--transducer``
    takes one ``--seconds`` value, excludes ``--pooled`` and
    ``--quantize``; a transducer artifact without its three roles does
    not load."""
    base = ["--checkpoint", "c.pt", "--dict_file", "d", "--output", "o",
            "--transducer", "true"]
    with pytest.raises(SystemExit, match="exclusive"):
        export_cli.parse_args(base + ["--pooled", "true"])
    with pytest.raises(SystemExit, match="CTC-path export option"):
        export_cli.parse_args(base + ["--quantize", "int8"])
    fake = tmp_path / "rnnt"
    fake.mkdir()
    with open(os.path.join(art["port"], "meta.json")) as f:
        meta = json.load(f)
    (fake / "meta.json").write_text(json.dumps(dict(meta,
                                                    kind="transducer")))
    shutil.copy(os.path.join(art["port"], "params.npz"), fake)
    with pytest.raises(ValueError, match="no .'decode_frames', "
                       "'decode_init', 'encode'. entries"):
        E.load_artifact(str(fake))


def test_export_parses_every_jax_flag():
    theirs = flags(captured_parser("audio8_tpu.cli.export"))
    ours = flags(captured_parser("audio8_tpu_torch.cli.export"))
    assert not set(theirs) - set(ours)
    for flag in theirs:
        if flag == "--platforms":  # cpu cuda, for JAX's cpu tpu
            assert ours[flag][0] == ["cpu", "cuda"]
            assert theirs[flag][0] == ["cpu", "tpu"]
            continue
        assert ours[flag] == theirs[flag] or (
            sorted(ours[flag][1] or []) == sorted(theirs[flag][1] or [])
            and ours[flag][0] == theirs[flag][0]), flag
    base = ["--checkpoint", "c.pt", "--dict_file", "d", "--output", "o"]
    with pytest.raises(SystemExit, match="--platforms tpu"):
        export_cli.parse_args(base + ["--platforms", "cpu", "tpu"])
    assert export_cli.parse_args(base + ["--lane_align", "false"]).lane_align \
        is False
