"""The four ``--exported`` decoding surfaces of the port against the JAX
package's on artifacts of one checkpoint (the committed fairseq golden
CTC checkpoint, exported by each package at one 1 s entry for the CPU;
``tests/test_torch_export.py`` has the geometry and the round trip).

* ``cli.transcribe --exported``, whole files and chunked, gives JAX's
  ``cli.transcribe --exported`` text on JAX's artifact;
* ``cli.test --exported`` gives JAX's WER and CER and the port's live
  checkpoint's at the entry's length grid;
* ``cli.serve --exported`` answers ``/transcribe`` with JAX's chunked
  text at the same window and context, ``/healthz`` with the
  artifact's sizes;
* ``cli.embed --exported`` on a ``cli.export --pooled`` artifact is
  within 1e-5 of JAX's ``cli.embed`` on the same weights and bitwise the
  port's live embedder; a CTC artifact is refused there.
"""
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio8_tpu.cli.embed as jax_embed
import audio8_tpu.cli.export as jax_export_cli
import audio8_tpu.cli.test as jax_test
import audio8_tpu.cli.transcribe as jax_transcribe
import audio8_tpu.config as jax_config
import audio8_tpu_torch.cli.embed as embed
import audio8_tpu_torch.cli.test as test_cli
import audio8_tpu_torch.cli.transcribe as transcribe
from audio8_tpu_torch import export as E
from audio8_tpu_torch.cli import export as export_cli
from audio8_tpu_torch.cli import serve as serve_cli
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_export import (ENTRY, GEOMETRY, SR, TOL,
                                     _patch_geometry, _write_wav,
                                     export_args, write_dict)
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_transcribe_cli import (FIX, LETTERS, SIZE,
                                             speech_with_silences)

cap_torch_threads()


@pytest.fixture(autouse=True)
def _golden_geometry(monkeypatch):
    _patch_geometry(monkeypatch)
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """The golden CTC checkpoint exported by both packages at one 1 s
    entry for the CPU, two 1 s files of tone bursts and a five-file letter
    corpus for ``cli.test``."""
    tmp = tmp_path_factory.mktemp("export_cli")
    dict_file = write_dict(tmp / "dict.ltr.txt")
    wavs = []
    for seed in (0, 1):
        wavs.append(str(tmp / f"utt{seed}.wav"))
        _write_wav(wavs[-1], speech_with_silences(seed)[:ENTRY])
    (tmp / "audio").mkdir()
    rng = np.random.default_rng(5)
    with open(tmp / "valid.tsv", "w") as tf, \
            open(tmp / "valid.ltr", "w") as lf:
        tf.write(str(tmp / "audio") + "\n")
        for i in range(5):
            n = 6_000 + 2_500 * i
            _write_wav(tmp / "audio" / f"v{i}.wav",
                       rng.normal(size=n).astype(np.float32) * 0.2)
            tf.write(f"v{i}.wav\t{n}\n")
            word = "".join(rng.choice(LETTERS[1:], size=3))
            lf.write(" ".join(word) + " |\n")
    ckpt = os.path.join(FIX, "ctc_tiny.pt")
    with pytest.MonkeyPatch.context() as mp:
        _patch_geometry(mp)
        port = export_cli.main(export_args(ckpt, dict_file, str(tmp / "port"),
                                           "--device", "cpu", "--platforms",
                                           "cpu"))
        theirs = jax_export_cli.main(export_args(
            ckpt, dict_file, str(tmp / "jax"), "--platforms", "cpu",
            "--lane_align", "false"))
    return dict(port=port, jax=theirs, wavs=wavs, root=tmp)


@pytest.mark.parametrize("chunked", [False, True])
def test_transcribe_exported_equals_jax(art, chunked):
    extra = ["--chunk_seconds", "1", "--context_seconds", "0.25"] \
        if chunked else []
    mine = transcribe.main(["--exported", art["port"], "--device", "cpu",
                            *extra, *art["wavs"]])
    theirs = jax_transcribe.main(["--exported", art["jax"], *extra,
                                  *art["wavs"]])
    assert mine == theirs
    assert all(text for _, text in mine)


def test_test_exported_scores_as_jax_and_the_live_checkpoint(art):
    common = ["--root_dir", str(art["root"]), "--valid_dataset",
              "valid.tsv", "--dict_file", "dict.ltr.txt"]
    mine = test_cli.evaluate(common + ["--exported", art["port"],
                                       "--device", "cpu"])
    theirs = jax_test.evaluate(common + ["--exported", art["jax"]])
    live = test_cli.evaluate(common + [
        "--checkpoint", os.path.join(FIX, "ctc_tiny.pt"), "--device", "cpu",
        "--length_buckets", str(ENTRY), *SIZE])
    keys = {"cer", "wer", "step"}
    assert {k: mine[k] for k in keys} == {k: theirs[k] for k in keys} \
        == {k: live[k] for k in keys}
    assert mine["utterances"] == 5


def test_serve_exported_answers_as_jax(art):
    args = serve_cli.parse_args(["--exported", art["port"], "--device",
                                 "cpu", "--context_seconds", "0.25",
                                 "--batch_wait_ms", "0"])
    service = serve_cli.build_service(args)
    assert service.transcriber.chunk == ENTRY
    srv = serve_cli.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        port = srv.server_address[1]
        with open(art["wavs"][0], "rb") as f:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/transcribe", data=f.read())
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    assert health["model"] == "wav2vec2-ctc (exported)"
    assert health["d_model"] == 64 and health["num_layers"] == 2
    theirs = jax_transcribe.main(["--exported", art["jax"],
                                  "--chunk_seconds", "1",
                                  "--context_seconds", "0.25",
                                  art["wavs"][0]])
    assert got["text"] == theirs[0][1]


@pytest.fixture(scope="module")
def pooled(tmp_path_factory):
    """One random pooled encoder (``mean``: no head weights) with the
    golden geometry as the JAX package's checkpoint and as the port's
    paired ``.pt`` (``tests/test_torch_embed.py``'s recipe), exported by
    the port at one 1 s entry."""
    from audio8_tpu.models.wav2vec2 import Wav2Vec2PooledEncoder as JaxPooled
    from audio8_tpu.train.checkpoint import save_checkpoint
    from audio8_tpu_torch.models.convert import params_from_jax

    root = tmp_path_factory.mktemp("pooled")
    cfg = jax_config.PooledConfig(
        d_model=64, num_heads=4, num_layers=2, d_ff=256, dropout=0.0,
        timestep_masking=0.0, channel_masking=0.0, freeze_fx=False,
        reduction_type="mean", custom_conv_features=GEOMETRY)
    params = JaxPooled(config=cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SR), jnp.float32),
        jnp.asarray([SR]))["params"]
    jax_ckpt = save_checkpoint(params, str(root / "ckpt"), 1)
    body = jax.tree.map(np.asarray, {"encoder": params["encoder"], "proj": {
        "kernel": np.zeros((64, 4), np.float32),
        "bias": np.zeros(4, np.float32)}})
    state = {embed.AUDIO_PREFIX + k: v
             for k, v in params_from_jax(body).items()
             if k.startswith("encoder.")}
    port_ckpt = str(root / "paired.pt")
    torch.save({"kind": "paired", "model": state}, port_ckpt)
    with pytest.MonkeyPatch.context() as mp:
        _patch_geometry(mp)
        out = export_cli.main([
            "--checkpoint", port_ckpt, "--pooled", "true",
            "--reduction_type", "mean", "--seconds", "1", *SIZE,
            "--output", str(root / "art"), "--device", "cpu",
            "--platforms", "cpu"])
    (root / "audio").mkdir()
    rng = np.random.default_rng(7)
    with open(root / "test.tsv", "w") as tf:
        tf.write(str(root / "audio") + "\n")
        for i in range(3):  # 0.6-1.0 s: every batch pads to 1 s
            n = 9_600 + 3_200 * i
            _write_wav(root / "audio" / f"u{i}.wav",
                       rng.normal(size=n).astype(np.float32) * 0.2)
            tf.write(f"u{i}.wav\t{n}\n")
    return dict(jax=jax_ckpt, port=port_ckpt, art=out, root=root)


def test_embed_exported_matches_jax(pooled, art, tmp_path):
    assert E.artifact_kind(pooled["art"]) == "embed"
    common = ["--root_dir", str(pooled["root"]), "--dataset", "test.tsv",
              "--reduction_type", "mean", "--batch", "2", *SIZE]
    mine, live, theirs = (str(tmp_path / n) for n in ("m", "l", "t"))
    assert embed.main(common + ["--exported", pooled["art"], "--device",
                                "cpu", "--output", mine]) == 0
    assert embed.main(common + ["--checkpoint", pooled["port"], "--device",
                                "cpu", "--output", live]) == 0
    assert jax_embed.main(common + ["--checkpoint", pooled["jax"],
                                    "--output", theirs]) == 0
    got = np.load(mine + ".npy")
    assert got.shape == (3, 64)
    assert np.array_equal(got, np.load(live + ".npy"))
    np.testing.assert_allclose(got, np.load(theirs + ".npy"), atol=TOL,
                               rtol=0)
    with pytest.raises(SystemExit, match="not an embed one"):
        embed.build_embedder(embed.parse_args(
            common + ["--exported", art["port"], "--device", "cpu"]))


