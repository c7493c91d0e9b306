"""``cli.convert_checkpoint`` of the port on the CPU: a fairseq CTC or
pretrained ``.pt`` becomes the port's ``{output}-step-0.pt`` with every
weight equal, which the JAX package's ``load_fairseq_bin`` reads with no
key missing or unexpected; a source key with no place in the model, or a
model key the source lacks, raises as the JAX converter does. An HF
``save_pretrained`` directory converts into the weights JAX's
``load_hf_dir`` reads from it, or raises as JAX does when the model
kind asked for is not the directory's."""
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


@pytest.mark.parametrize("family", ["wav2vec2_stable_ln", "wavlm",
                                    "conformer_relative"])
def test_hf_input_converts_as_in_jax(tmp_path, family):
    """Sizes and topology from the HF config, whatever the flags say; the
    written ``.pt`` holds JAX's weights and reads back in JAX with the
    topology's converter."""
    import jax
    import numpy as np

    from audio8_tpu.models.convert_hf import load_hf_dir as jax_load_hf_dir
    from audio8_tpu_torch.models.convert import params_from_jax
    from tests.test_torch_hf import unpack_fixture

    d, _, _ = unpack_fixture(family, tmp_path / "hf")
    out = convert_checkpoint.main(["--input", d, "--output",
                                   str(tmp_path / "c"), "--ctc", "true",
                                   *FLAGS])
    got = load_fairseq_ctc(out)
    jparams, report = jax_load_hf_dir(d, ctc=True)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    topo = report["topology"]
    _, back = load_fairseq_bin(out, ctc=True, num_layers=2, **topo)
    assert back["missing"] == [] and back["unexpected"] == []


def test_hf_input_of_the_wrong_kind_raises(tmp_path):
    """A ForCTC directory read as a pretrained model leaves its head
    unmapped: both converters raise and nothing is written."""
    from audio8_tpu.models.convert_hf import load_hf_dir as jax_load_hf_dir
    from tests.test_torch_hf import unpack_fixture

    d, _, _ = unpack_fixture("wav2vec2", tmp_path / "hf")
    assert jax_load_hf_dir(d, ctc=False)[1]["unexpected"]
    with pytest.raises(ValueError, match="Unmapped checkpoint keys"):
        convert_checkpoint.main(["--input", d, "--output",
                                 str(tmp_path / "c")])
    assert not os.path.exists(str(tmp_path / "c-step-0.pt"))
