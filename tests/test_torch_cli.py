"""The port's CLI entry points on the CPU: a fairseq-layout CTC checkpoint
written by the port loads through ``transcribe``'s ``load_acoustic``, the
one-shot and chunked paths agree, and ``serve.build_service`` serves."""
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu.config import AcousticConfig
from audio8_tpu_torch.cli import serve as serve_cli
from audio8_tpu_torch.cli import transcribe
from audio8_tpu_torch.models.convert import load_fairseq_ctc, save_fairseq_ctc
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

LETTERS = ["|", "E", "T", "A"]
SIZE = ["--d_model", "32", "--num_heads", "2", "--num_layers", "1",
        "--d_ff", "64", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _restore_port_offsets():
    """The CLIs remap the port's process-global ``Offsets``; put it back
    after each test."""
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    cfg = AcousticConfig(num_labels=4 + len(LETTERS), d_model=32,
                         num_heads=2, num_layers=1, d_ff=64,
                         timestep_masking=0.0, channel_masking=0.0)
    model = Wav2Vec2AcousticModel(cfg,
                                  generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp / "ctc.pt")
    save_fairseq_ctc(model, ckpt)
    dict_file = str(tmp / "dict.ltr.txt")
    with open(dict_file, "w") as f:
        f.writelines(f"{c} 10\n" for c in LETTERS)
    wav = np.random.default_rng(0).normal(size=40_000) * 0.1
    wav_path = str(tmp / "a.wav")
    wavfile.write(wav_path, 16_000, (wav * 32767).astype(np.int16))
    return model, ckpt, dict_file, wav_path


def test_checkpoint_round_trip(files):
    model, ckpt, _, _ = files
    state = load_fairseq_ctc(ckpt)
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v), k


def test_transcribe_one_shot_and_chunked(files, capsys):
    model, ckpt, dict_file, wav_path = files
    base = ["--checkpoint", ckpt, "--dict_file", dict_file, *SIZE, wav_path]
    one_shot = transcribe.main(base)
    chunked = transcribe.main(base + ["--chunk_seconds", "3",
                                      "--context_seconds", "0.5"])
    assert Offsets.GO == 0  # the fairseq CTC layout: <s> is the blank
    assert one_shot[0][0] == wav_path and isinstance(one_shot[0][1], str)
    # 2.5 s of audio: the one-shot path pads to 3 s, the one 3 s chunk is
    # the same window, so both decode the same frames
    assert chunked == one_shot
    assert f"{wav_path}\t" in capsys.readouterr().out


def test_load_acoustic_forward_contract(files):
    _, ckpt, dict_file, wav_path = files
    args = transcribe.parse_args(["--checkpoint", ckpt, "--dict_file",
                                  dict_file, *SIZE, wav_path])
    cfg, forward, vocab, _, device = transcribe.load_acoustic(args)
    assert device.type == "cpu" and len(vocab) == 8
    lp, frames = forward(torch.zeros(2, 16_000),
                         torch.tensor([16_000, 8_000]))
    assert lp.shape == (2, 49, 8) and lp.dtype == torch.float32
    assert frames.tolist() == [49, 24]
    assert torch.isfinite(lp).all()


def test_build_service(files):
    _, ckpt, dict_file, _ = files
    args = serve_cli.parse_args(["--checkpoint", ckpt, "--dict_file",
                                 dict_file, *SIZE, "--chunk_seconds", "2",
                                 "--context_seconds", "0.5", "--batch", "2"])
    service = serve_cli.build_service(args)
    try:
        health = service.health()
        assert health["ok"] and health["d_model"] == 32
        assert health["batcher"]["dispatches"] == 1  # the warm-up
        lp = service.log_probs(np.zeros(50_000, np.float32))
        assert lp.shape[1] == 8 and np.isfinite(lp).all()
    finally:
        service.transcriber.batcher.close()


def test_bf16_flag(files):
    _, ckpt, dict_file, wav_path = files
    args = transcribe.parse_args(["--checkpoint", ckpt, "--dict_file",
                                  dict_file, *SIZE, "--bf16", wav_path])
    _, model, _, _ = transcribe.build_acoustic(args, torch.device("cpu"))
    assert model.encoder.post_extract_proj.compute_dtype == torch.bfloat16
    assert next(model.parameters()).dtype == torch.float32


def test_host_helpers_match_jax(tmp_path):
    """The jax-bound host helpers the port re-implements give the JAX
    package's answers: greedy decode and collapse, post-processing, and
    both vocab formats."""
    import json

    import jax.numpy as jnp

    from audio8_tpu.models.text import read_vocab_list as jax_vocab
    from audio8_tpu.ops import ctc as jax_ctc
    from audio8_tpu.ops import metrics as jax_metrics
    from audio8_tpu_torch.models.text import read_vocab_list
    from audio8_tpu_torch.ops import ctc, metrics

    lp = np.random.default_rng(3).normal(size=(2, 30, 6)).astype(np.float32)
    frames = ctc.ctc_greedy_decode(torch.from_numpy(lp))
    np.testing.assert_array_equal(
        frames.numpy(), np.asarray(jax_ctc.ctc_greedy_decode(jnp.asarray(lp))))
    for row in frames.numpy():
        assert ctc.greedy_collapse(row, 0) == jax_ctc.greedy_collapse(row, 0)
    for words in (["H", "I", "|", "Y", "O", "|"], ["he@@", "llo", "world"]):
        assert metrics.postproc_letters(words) == \
            jax_metrics.postproc_letters(words)
        assert metrics.postproc_bpe(words) == jax_metrics.postproc_bpe(words)
    ltr = tmp_path / "dict.ltr.txt"
    ltr.write_text("| 5\nE 4\n\nT 3\n")
    hf = tmp_path / "vocab.json"
    hf.write_text(json.dumps({"<pad>": 0, "a": 1, "|": 3}))
    for path in (str(ltr), str(hf)):
        assert read_vocab_list(path) == jax_vocab(path)
