"""The committed fairseq golden CTC checkpoint through the port: loaded
with ``torch.load(weights_only=True)`` by prefix mapping alone, its
log-probs match the pinned ``expected.npz`` of the fairseq replica."""
import json
import os

import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig
from audio8_tpu_torch.models.convert import load_fairseq_ctc
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "fairseq_golden")


@pytest.fixture(scope="module")
def model():
    with open(os.path.join(FIX, "MANIFEST.json")) as f:
        geom = json.load(f)["geometry"]
    cfg = AcousticConfig(
        num_labels=geom["num_labels"], d_model=geom["d_model"],
        num_heads=geom["num_heads"], num_layers=geom["num_layers"],
        custom_conv_features=tuple(tuple(b) for b in geom["fx"]),
        dropout=0.0, timestep_masking=0.0, channel_masking=0.0)
    m = Wav2Vec2AcousticModel(cfg)
    m.load_state_dict(load_fairseq_ctc(os.path.join(FIX, "ctc_tiny.pt")),
                      strict=True)
    return m.eval()


def test_ctc_golden_log_probs(model):
    expected = np.load(os.path.join(FIX, "expected.npz"))
    with torch.inference_mode():
        lp, _ = model(torch.from_numpy(expected["__input__"]))
    want = expected["ctc_log_probs"]
    assert lp.shape == want.shape == (2, 399, 12)
    np.testing.assert_allclose(lp.numpy(), want, atol=3e-4)
    assert (lp.numpy().argmax(-1) == want.argmax(-1)).mean() > 0.999


def test_weights_only_load_refuses_without_the_allowlist():
    """The checkpoint carries an argparse.Namespace: a bare weights-only
    load refuses it, the port's loader allow-lists exactly that class."""
    with pytest.raises(Exception, match="Namespace"):
        torch.load(os.path.join(FIX, "ctc_tiny.pt"), map_location="cpu",
                   weights_only=True)
