"""The port's RNN-T model (``models/transducer.py``) against the JAX
``Transducer`` on the CPU, on weights carried by ``params_from_jax`` and
seeded inputs, the JAX functions jitted as the JAX package runs them:

* the LSTM cell's sequence path equals its step path;
* the predictor, in f32 and in bf16: under bf16 the training sequence's
  float32 carry (f32 output; XLA leaves ``f``, ``o`` and ``i * g``
  unrounded, as the port does) and the decode step's bf16 carry,
  bitwise equal to JAX's, and the bf16 joint's float32 logits;
* the training forward's log-probs at 1e-4 in f32, and in bf16 on the
  same encoder features (the bf16 encoder is held to JAX by the
  trajectories of ``test_torch_bf16.py``).

The decodes are in ``test_torch_transducer_decode.py``, on this file's
weights: the joint's blank bias raised so that decoding mixes blanks and
labels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import TransducerConfig as JaxConfig
from audio8_tpu.models.transducer import Transducer as JaxTransducer
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch.config import TransducerConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.transducer import _RNN, Transducer
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FX = ((32, 10, 5), (32, 3, 2))
V = 10
CFG = dict(vocab_size=V, d_model=32, num_heads=2, num_layers=2, d_ff=64,
           pred_layers=2, pred_dim=24, pred_embed_dim=16, d_joint=20,
           timestep_masking=0.0, channel_masking=0.0, dropout=0.0,
           pred_dropout=0.0, custom_conv_features=FX)
LENGTHS = np.array([4000, 3100, 1500], np.int32)
MAX_LEN, MAX_SYM = 24, 3


@pytest.fixture(autouse=True)
def _fairseq_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    Offsets.remap_fairseq_ctc()
    JaxOffsets.remap_fairseq_ctc()
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 4000)).astype(np.float32)
    x[np.arange(4000)[None, :] >= LENGTHS[:, None]] = 0.0
    y = rng.integers(4, V, size=(3, 5)).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def params():
    JaxOffsets.remap_fairseq_ctc()
    x, y = _inputs()
    model = JaxTransducer(config=JaxConfig(**CFG))
    p = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(LENGTHS),
        jnp.asarray(y))["params"])
    p["joint"]["out"]["bias"][0] += 1.5  # blank (GO = 0) competes
    return p


def _both(params, dtype=torch.float32):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmodel = JaxTransducer(config=JaxConfig(**CFG), dtype=jdt)
    model = Transducer(TransducerConfig(**CFG), dtype)
    model.load_state_dict(params_from_jax(params), strict=True)
    return jmodel, model.eval()


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_lstm_cell_sequence_equals_steps():
    rnn = _RNN(8, 16)
    gen = torch.Generator().manual_seed(0)
    for m in rnn.modules():
        if hasattr(m, "init_from"):
            m.init_from(gen)
    cell = rnn.cell
    x = torch.randn(3, 6, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        seq = rnn(x)
        carry = (torch.zeros(3, 16), torch.zeros(3, 16))
        outs = []
        for t in range(6):
            packed = cell.packed()
            carry = cell.step(carry, cell.input_proj(x[:, t], packed), packed)
            outs.append(carry[1])
    torch.testing.assert_close(seq, torch.stack(outs, 1), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_predictor_matches_jax(params, dtype):
    jmodel, model = _both(params, dtype)
    _, y = _inputs()
    ids = np.concatenate([np.zeros((3, 1), np.int32), y], 1)
    want = jax.jit(lambda p, i: jmodel.apply(
        {"params": p}, i, method=lambda m, i: m.predictor(i)))(params, ids)
    with torch.no_grad():
        got = model.predictor(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32  # the training carry is float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)

    def jstep(p, carry, tok):
        return jmodel.apply({"params": p}, carry, tok,
                            method=lambda m, c, t: m.predictor.step(c, t))

    jstep = jax.jit(jstep)
    jcarry = jax.jit(lambda p: jmodel.apply(
        {"params": p}, 3, method=lambda m, b: m.predictor.init_carry(b)))(
        params)
    carry = model.predictor.init_carry(3)
    assert carry[0][0].dtype == dtype  # the decode carry is the dtype's
    for u in range(ids.shape[1]):
        jout, jcarry = jstep(params, jcarry, jnp.asarray(ids[:, u]))
        with torch.no_grad():
            out, carry = model.predictor.step(carry,
                                              torch.from_numpy(ids[:, u]))
        np.testing.assert_allclose(out.float().numpy(), _np(jout),
                                   rtol=0, atol=1e-6 if dtype ==
                                   torch.float32 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_log_probs_match_jax(params, dtype):
    jmodel, model = _both(params, dtype)
    x, y = _inputs()
    jlp, jmask = jax.jit(lambda p, x, n, y: jmodel.apply(
        {"params": p}, x, n, y))(params, x, LENGTHS, y)
    if dtype == torch.float32:
        with torch.no_grad():
            lp, mask = model(torch.from_numpy(x), torch.from_numpy(LENGTHS),
                             torch.from_numpy(y))
        assert torch.equal(mask, torch.from_numpy(np.asarray(jmask)))
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-4,
                                   atol=1e-4)
        return
    # bf16: the predictor, joint and log-softmax on JAX's own features
    enc, _ = jax.jit(lambda p, x, n: jmodel.apply(
        {"params": p}, x, n, method=JaxTransducer.encode))(params, x,
                                                           LENGTHS)
    ids = np.concatenate([np.zeros((3, 1), np.int32), y], 1)
    want = jax.jit(lambda p, e, i: jax.nn.log_softmax(jmodel.apply(
        {"params": p}, e, i, method=lambda m, e, i: m.joint(
            e, m.predictor(i))), axis=-1))(params, enc, ids)
    with torch.no_grad():
        e = torch.from_numpy(_np(enc)).to(torch.bfloat16)
        got = torch.log_softmax(model.joint(e, model.predictor(
            torch.from_numpy(ids).long())), dim=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
