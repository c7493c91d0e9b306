"""``cli.convert_checkpoint`` of the port on the CPU: a fairseq CTC or
pretrained ``.pt`` becomes the port's ``{output}-step-0.pt`` with every
weight equal, which the JAX package's ``load_fairseq_bin`` reads with no
key missing or unexpected; a source key with no place in the model, or a
model key the source lacks, raises as the JAX converter does; HF input
raises naming its ROADMAP.md item."""
import os

import pytest
import torch

from audio8_tpu.models.convert import load_fairseq_bin
from audio8_tpu_torch.cli import convert_checkpoint
from audio8_tpu_torch.config import AcousticConfig, PretrainConfig
from audio8_tpu_torch.models.convert import (load_fairseq_ctc,
                                             load_fairseq_pretrained,
                                             save_fairseq_ctc,
                                             save_fairseq_pretrained)
from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2AcousticModel,
                                              Wav2Vec2Model)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

SIZE = dict(d_model=32, num_heads=2, num_layers=1, d_ff=64)
FLAGS = ["--d_model", "32", "--num_heads", "2", "--num_layers", "1",
         "--d_ff", "64"]


def _source(tmp_path, ctc: bool):
    gen = torch.Generator().manual_seed(3)
    path = str(tmp_path / "source.pt")
    if ctc:
        model = Wav2Vec2AcousticModel(AcousticConfig(num_labels=12, **SIZE),
                                      generator=gen)
        save_fairseq_ctc(model, path)
    else:
        model = Wav2Vec2Model(PretrainConfig(final_dim=16, num_vq_vars=8,
                                             **SIZE), generator=gen)
        save_fairseq_pretrained(model, path)
    return model, path


@pytest.mark.parametrize("ctc", [True, False])
def test_fairseq_input_converts_whole(tmp_path, ctc):
    model, source = _source(tmp_path, ctc)
    out = convert_checkpoint.main(
        ["--input", source, "--output", str(tmp_path / "out" / "checkpoint"),
         "--ctc", str(ctc).lower(), "--num_labels", "12", *FLAGS])
    assert out == str(tmp_path / "out" / "checkpoint-step-0.pt")
    got = (load_fairseq_ctc if ctc else load_fairseq_pretrained)(out)
    want = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _, report = load_fairseq_bin(out, ctc=ctc, num_layers=1)
    assert report["missing"] == [] and report["unexpected"] == []


@pytest.mark.parametrize("edit", ["extra", "missing"])
def test_unmapped_keys_raise(tmp_path, edit):
    _, source = _source(tmp_path, True)
    blob = torch.load(source, weights_only=True)
    if edit == "extra":
        blob["model"]["w2v_encoder.w2v_model.extra.weight"] = torch.zeros(1)
    else:
        del blob["model"]["w2v_encoder.proj.bias"]
    torch.save(blob, source)
    with pytest.raises(ValueError, match="Unmapped checkpoint keys"):
        convert_checkpoint.main(["--input", source, "--output",
                                 str(tmp_path / "c"), "--ctc", "true",
                                 "--num_labels", "12", *FLAGS])


def test_hf_input_raises_naming_its_item(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="item 7"):
        convert_checkpoint.main(["--input", str(tmp_path), "--output",
                                 str(tmp_path / "c")])
    assert not os.path.exists(str(tmp_path / "c-step-0.pt"))
