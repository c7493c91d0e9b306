"""HuggingFace ``save_pretrained`` directories in the port
(``models/convert_hf.py``) against the JAX package's loader.

* The seven committed golden fixtures (``tests/fixtures/hf_golden``:
  weights, config, input and the log-probs ``transformers`` computed)
  load through the port's ``load_hf_dir`` with nothing missing or left
  over, into the same tensors as JAX's ``load_hf_dir`` moved across with
  ``params_from_jax``, and the port's forward gives the fixture's
  log-probs and JAX's within 1e-4.
* The port's own safetensors reader against the ``safetensors``
  package's writer (which the tests may use and the port may not) for
  every dtype, with a ``__metadata__`` entry; the ``pytorch_model.bin``
  branch; WavLM's unilm key spellings.
* ``cli.inspect_checkpoint`` on an HF directory gives JAX's summary.
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.models.convert import merge_params
from audio8_tpu.models.convert_hf import \
    acoustic_config_from_hf as jax_config_from_hf
from audio8_tpu.models.convert_hf import load_hf_dir as jax_load_hf_dir
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu_torch.cli import inspect_checkpoint
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.convert_hf import (acoustic_config_from_hf,
                                                load_hf_dir,
                                                read_safetensors)
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(ROOT, "fixtures", "hf_golden")
FAMILIES = sorted(os.path.basename(p)[:-4]
                  for p in glob.glob(os.path.join(FIXTURE_DIR, "*.npz")))


def unpack_fixture(family: str, directory, weights: str = "safetensors"):
    """Write golden fixture ``family`` as a ``save_pretrained`` directory
    (config.json and ``model.safetensors`` through the ``safetensors``
    package, or ``pytorch_model.bin``); returns ``(dir, input, the
    fixture's log-probs)``."""
    from safetensors.numpy import save_file

    blob = np.load(os.path.join(FIXTURE_DIR, family + ".npz"))
    state = {k[len("state::"):]: np.ascontiguousarray(blob[k])
             for k in blob.files if k.startswith("state::")}
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        f.write(bytes(blob["__config_json__"]).decode("utf-8"))
    if weights == "safetensors":
        save_file(state, os.path.join(directory, "model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   os.path.join(directory, "pytorch_model.bin"))
    return str(directory), blob["__input__"], blob["__log_probs__"]


def test_all_seven_families_are_here():
    assert FAMILIES == ["conformer_relative", "conformer_rotary",
                        "data2vec_audio", "hubert", "wav2vec2",
                        "wav2vec2_stable_ln", "wavlm"]


@pytest.mark.parametrize("family", FAMILIES)
def test_golden_fixture_matches_transformers_and_jax(family, tmp_path):
    d, x, want = unpack_fixture(family, tmp_path / "hf")
    state, report = load_hf_dir(d, ctc="auto")
    assert report["kind"] == "ctc"
    assert report["missing"] == [] and report["unexpected"] == []
    jparams, jreport = jax_load_hf_dir(d, ctc="auto")
    assert report["topology"] == jreport["topology"]
    ours = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(state) == set(ours)
    for k in state:
        assert torch.equal(state[k], ours[k]), k

    cfg = acoustic_config_from_hf(report["hf_config"], report["topology"])
    model = Wav2Vec2AcousticModel(cfg)
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        lp, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(lp.numpy(), want, atol=1e-4)

    jmodel = JaxModel(config=jax_config_from_hf(jreport["hf_config"],
                                                jreport["topology"]))
    init = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    jlp, _ = jax.jit(jmodel.apply)({"params": merge_params(init, jparams)},
                                   jnp.asarray(x))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-4)


def test_pytorch_model_bin_loads_as_safetensors(tmp_path):
    a, _, _ = unpack_fixture("wav2vec2_stable_ln", tmp_path / "st")
    b, _, _ = unpack_fixture("wav2vec2_stable_ln", tmp_path / "bin", "bin")
    assert not os.path.exists(os.path.join(b, "model.safetensors"))
    sa, ra = load_hf_dir(a, ctc=True)
    sb, rb = load_hf_dir(b, ctc=True)
    assert ra["missing"] == rb["missing"] == []
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float64,
          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.bool]


def _tensors():
    g = torch.Generator().manual_seed(0)
    out = {}
    for i, dt in enumerate(DTYPES):
        x = torch.randn(3, 5, generator=g) * 50
        out[f"t{i}"] = (x > 0) if dt == torch.bool else x.to(dt)
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros(0, 4)
    return out


def test_safetensors_reader_matches_the_package(tmp_path):
    """Every dtype, a 0-dim and an empty tensor, and a ``__metadata__``
    entry in the header, as the package writes them."""
    from safetensors.torch import save_file

    path = str(tmp_path / "a.safetensors")
    want = _tensors()
    save_file(want, path, metadata={"format": "pt", "note": "x"})
    got = read_safetensors(path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_safetensors_reader_holds_the_file_once(tmp_path):
    """The tensors of a file the package wrote (its header padded to 8
    bytes) are views of one buffer; a header of any other length, as a
    hand-written file may have, gives misaligned offsets, read into
    aligned copies with the same values."""
    import json

    from safetensors.torch import save_file

    want = {k: v for k, v in _tensors().items() if v.numel()}
    path = str(tmp_path / "a.safetensors")
    save_file(want, path)
    got = read_safetensors(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        offsets = {k: v["data_offsets"][0]
                   for k, v in json.loads(f.read(n)).items() if k in want}
    base = {got[k].data_ptr() - o for k, o in offsets.items()}
    assert len(base) == 1  # every tensor at its file offset in one buffer
    header, raw = {}, b""
    for k, v in want.items():
        b = v.reshape(-1).view(torch.uint8).numpy().tobytes()
        dtype = {torch.float64: "F64", torch.float32: "F32",
                 torch.float16: "F16",
                 torch.bfloat16: "BF16", torch.int64: "I64",
                 torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
                 torch.uint8: "U8", torch.bool: "BOOL"}[v.dtype]
        header[k] = {"dtype": dtype, "shape": list(v.shape),
                     "data_offsets": [len(raw), len(raw) + len(b)]}
        raw += b
    text = json.dumps(header).encode()
    text += b" " * ((8 - len(text) % 8) % 8 + 1)  # data start = 1 mod 8
    odd = str(tmp_path / "odd.safetensors")
    with open(odd, "wb") as f:
        f.write(len(text).to_bytes(8, "little") + text + raw)
    got = read_safetensors(odd)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("family", ["wav2vec2", "conformer_rotary"])
def test_inspect_summarises_an_hf_directory_as_jax(family, tmp_path):
    from audio8_tpu.cli import inspect_checkpoint as jax_inspect

    d, _, _ = unpack_fixture(family, tmp_path / "hf")
    ours = inspect_checkpoint.main([d, "--json"])
    theirs = jax_inspect.main([d, "--json"])
    assert ours["format"] == theirs["format"] == "huggingface save_pretrained"
    for k in ("step", "leaves", "total_params", "optimizer_state",
              "by_dtype", "by_module"):
        assert ours[k] == theirs[k], k
    assert json.loads(json.dumps(ours)) == ours


def test_unilm_wavlm_names_load_as_hf_ones(tmp_path):
    """The official WavLM ``.pt`` spells the gate ``grep_linear`` /
    ``grep_a`` and the bucket table ``relative_attention_bias``; the
    fairseq loaders rename them (the JAX ``_WAVLM_FAIRSEQ_ALIASES``)."""
    from audio8_tpu_torch.models.convert import from_fairseq_ctc_state
    from audio8_tpu_torch.models.convert_hf import (hf_to_fairseq_state,
                                                    read_hf_weights)

    d, _, _ = unpack_fixture("wavlm", tmp_path / "hf")
    fairseq, _ = hf_to_fairseq_state(read_hf_weights(d), ctc=True)
    unilm = {}
    for k, v in fairseq.items():
        k = (k.replace(".gru_rel_pos_linear.", ".grep_linear.")
             .replace(".gru_rel_pos_const", ".grep_a")
             .replace(".rel_attn_embed.", ".relative_attention_bias."))
        unilm[k] = v
    assert any(".grep_a" in k for k in unilm)
    want, _ = from_fairseq_ctc_state(fairseq)
    got, _ = from_fairseq_ctc_state(unilm)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
