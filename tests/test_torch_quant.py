"""int8 serving weights of the port (``ops/quant.py``, the int8 branch of
``nn.layers.Dense``) against the JAX package's ``ops/quant.py`` and
``nn/layers.py:int8_dot`` on seeded numpy inputs: the codes and scales
bitwise, ``int8_dot`` in float32 and bfloat16 within one ulp of JAX's
(the int32 products bitwise), the quantized-layer count of the acoustic
model, the JAX-quantized tree through ``params_from_jax``, each quantized
``Dense.forward`` (bias included, seeded nonzero) against JAX's ``Dense``
within one ulp in float32 and bfloat16, and the tiny int8 acoustic model
against JAX's int8 model (each quantized layer on JAX's own inputs within
one ulp; the log-probs within the quantization's own error, see
``test_int8_model_matches_jax``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.cli.test import evaluate as jax_evaluate
from audio8_tpu.config import AcousticConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu.nn.layers import int8_dot as jax_int8_dot
from audio8_tpu.ops import quant as jax_quant
from audio8_tpu_torch.cli import test as test_cli
from audio8_tpu_torch.config import AcousticConfig as PortConfig
from audio8_tpu_torch.models.convert import params_from_jax, save_fairseq_ctc
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.nn.layers import Dense
from audio8_tpu_torch.ops import quant
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_train_cli import corpus  # noqa: F401 - a fixture

cap_torch_threads()

# the extractor at width 64, so post_extract_proj is quantized too
CFG = AcousticConfig(
    num_labels=8, d_model=64, num_heads=4, num_layers=2, d_ff=128,
    dropout=0.0, timestep_masking=0.0, channel_masking=0.0,
    custom_conv_features=((64, 10, 5), (64, 3, 2), (64, 3, 2), (64, 3, 2),
                          (64, 3, 2), (64, 2, 2), (64, 2, 2)))


def _ulp(a: np.ndarray, dtype) -> np.ndarray:
    """One unit in the last place of ``a``'s values in ``dtype`` (f32 or
    bf16: 8 bits of mantissa)."""
    mant = 23 if dtype == np.float32 else 7
    exp = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(exp - mant)


def test_codes_and_scales_bitwise():
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(96, 72)).astype(np.float32)  # JAX (in, out)
    kernel[:, 5] = 0.0  # an all-zero channel takes the 1e-12 floor
    kq, scale = jax_quant.quantize_kernel(kernel)
    codes, ours = quant.quantize_kernel(torch.from_numpy(kernel.T.copy()))
    assert codes.dtype == torch.int8 and ours.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(kq).T)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [3, 40])  # 3 rows take the padded path
def test_int8_dot_within_one_ulp_of_jax(dtype, rows):
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, 96)).astype(np.float32)
    x[1] = 0.0  # an all-zero row takes the 1e-8 floor
    kernel = rng.normal(size=(96, 64)).astype(np.float32)
    kq, kscale = jax_quant.quantize_kernel(kernel)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax_int8_dot(jnp.asarray(x).astype(jdt), kq, kscale,
                                   jdt).astype(jnp.float32))
    codes, scale = quant.quantize_kernel(torch.from_numpy(kernel.T.copy()))
    got = quant.int8_dot(torch.from_numpy(x).to(tdt), codes, scale,
                         tdt).float().numpy()
    np_dt = np.float32 if dtype == "float32" else "bf16"
    assert np.all(np.abs(got - want) <= _ulp(want, np_dt)), \
        np.abs(got - want).max()
    # the activation codes and the int32 products bitwise: JAX's steps
    xj = jnp.asarray(x).astype(jdt)
    x_scale = jnp.maximum(jnp.max(jnp.abs(xj), -1, keepdims=True),
                          1e-8) / 127.0
    xq = np.asarray(jnp.clip(jnp.round(xj / x_scale), -127, 127)
                    .astype(jnp.int8))
    ours, _ = quant.quantize_rows(torch.from_numpy(x).to(tdt))
    np.testing.assert_array_equal(ours.numpy(), xq)
    np.testing.assert_array_equal(
        quant.int_mm(ours, codes).numpy(),
        xq.astype(np.int32) @ np.asarray(kq).astype(np.int32))


def test_int_mm_refuses_what_cuda_refuses():
    a = torch.zeros(20, 12, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int_mm(a, torch.zeros(16, 12, dtype=torch.int8))
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int_mm(torch.zeros(20, 16, dtype=torch.int8),
                     torch.zeros(12, 16, dtype=torch.int8))


def test_dense_quantizes_into_buffers():
    d = Dense(96, 64)
    d.init_from(torch.Generator().manual_seed(0))
    quant.quantize_model_params(d)
    assert d.weight.dtype == torch.int8 and "weight" in dict(d.named_buffers())
    assert [n for n, _ in d.named_parameters()] == ["bias"]
    assert d.weight_scale.shape == (64,)
    with pytest.raises(ValueError, match="matched no Dense"):
        quant.quantize_model_params(d)  # nothing left to quantize


def _seeded_biases(params, seed: int):
    """``params`` with every bias drawn from a seeded normal: JAX's
    ``Dense`` and the port's ``init_from`` both zero them, which would
    leave the int8 ``Dense``'s bias add untested."""
    rng = np.random.default_rng(seed)

    def draw(path, v):
        if path[-1].key != "bias":
            return v
        return jnp.asarray(rng.normal(size=v.shape) * 0.1, v.dtype)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(config=CFG)
    params = _seeded_biases(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8000), jnp.float32))["params"],
        seed=5)
    qparams = jax_quant.quantize_model_params(params)
    _, jax_count = jax_quant.quantize_dense_tree(params)
    model = Wav2Vec2AcousticModel(CFG)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    count = quant.quantize_model_params(model)
    return jm, qparams, jax_count, model.eval(), count, params


def test_quantized_count_equals_jax(models):
    _, _, jax_count, model, count, _ = models
    # post_extract_proj, q/k/v/out_proj, fc1, fc2 per layer; not the head
    assert count == jax_count == 1 + 6 * CFG.num_layers
    assert model.proj.weight.dtype == torch.float32


def test_jax_quantized_tree_loads(models):
    _, qparams, _, model, _, _ = models
    state = params_from_jax(jax.tree.map(np.asarray, qparams))
    mine = model.state_dict()
    assert state.keys() == mine.keys()
    for k, v in state.items():
        assert v.dtype == mine[k].dtype and torch.equal(v, mine[k]), k


def test_int8_model_matches_jax(models, monkeypatch):
    """Activation quantization is discontinuous: the float path's 1e-6
    differences move a few activation codes of the port's model by one
    step against JAX's (one in 9 472 at the first attention input here),
    and one step moves that layer's output by about 1e-3. So every
    quantized layer is held to JAX on the input JAX's model gave it,
    within one ulp, and the whole model's log-probs to JAX's within the
    quantization's own error (JAX's int8 vs its float model)."""
    import audio8_tpu.nn.layers as jax_layers

    jm, qparams, _, model, _, params = models
    calls = []

    def recorded(x, kernel_q, kernel_scale, out_dtype):
        y = jax_int8_dot(x, kernel_q, kernel_scale, out_dtype)
        calls.append([np.asarray(a) for a in (x, kernel_q, kernel_scale, y)])
        return y

    monkeypatch.setattr(jax_layers, "int8_dot", recorded)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 24_000)) * 0.1).astype(np.float32)
    lens = np.array([24_000, 17_000])
    want, mask = jm.apply({"params": qparams}, jnp.asarray(x),
                          jnp.asarray(lens))
    assert len(calls) == 1 + 6 * CFG.num_layers
    for xi, kq, ks, yi in calls:
        got = quant.int8_dot(torch.from_numpy(xi.copy()),
                             torch.from_numpy(kq.T.copy()),
                             torch.from_numpy(ks.copy()),
                             torch.float32).numpy()
        assert np.all(np.abs(got - yi) <= _ulp(yi, np.float32))
    monkeypatch.undo()
    float_lp, _ = jm.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(lens))
    with torch.inference_mode():
        got, tmask = model(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    valid = np.asarray(mask)
    got, want = got.numpy()[valid], np.asarray(want)[valid]
    quant_err = np.abs(want - np.asarray(float_lp)[valid]).max()
    assert np.abs(got - want).max() <= quant_err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_forward_within_one_ulp_of_jax_dense(models, dtype):
    """Each quantized ``Dense.forward`` of the port's model (the int8
    product, then the bias added in the compute dtype: in bfloat16 a
    second rounding) against JAX's ``Dense`` on the input JAX's int8
    model gave it, with seeded nonzero biases, within one ulp of the
    compute dtype."""
    import flax.linen as flax_nn

    import audio8_tpu.nn.layers as jax_layers

    _, _, _, _, _, params = models
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    model = Wav2Vec2AcousticModel(CFG, tdt)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    quant.quantize_model_params(model)
    by_codes = {m.weight.numpy().tobytes(): m for m in model.modules()
                if isinstance(m, Dense) and m.weight.dtype == torch.int8}
    calls = []

    def recorded(next_fun, args, kwargs, context):
        y = next_fun(*args, **kwargs)
        if isinstance(context.module, jax_layers.Dense):
            kernel = context.module.variables["params"]["kernel"]
            if kernel.dtype == jnp.int8:
                calls.append([np.array(a, np.float32) if a.dtype != jnp.int8
                              else np.asarray(a) for a in (args[0], kernel, y)])
        return y

    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 24_000)) * 0.1).astype(np.float32)
    lens = np.array([24_000, 17_000])
    with flax_nn.intercept_methods(recorded):
        JaxModel(config=CFG, dtype=jdt).apply(
            {"params": jax_quant.quantize_model_params(params)},
            jnp.asarray(x), jnp.asarray(lens))
    assert len(calls) == len(by_codes) == 1 + 6 * CFG.num_layers
    assert all(np.abs(y).max() > 0 for _, _, y in calls)
    np_dt = np.float32 if dtype == "float32" else "bf16"
    for xi, kq, want in calls:
        layer = by_codes[np.ascontiguousarray(kq.T).tobytes()]
        assert layer.bias.abs().min() > 0
        with torch.inference_mode():
            got = layer(torch.from_numpy(xi).to(tdt)).float().numpy()
        assert np.all(np.abs(got - want) <= _ulp(want, np_dt)), \
            np.abs(got - want).max()


def test_cli_test_int8_scores_as_jax_does(corpus, tmp_path):  # noqa: F811
    """``cli.test --quantize int8`` against JAX's ``a8t-test --quantize
    int8`` on one fairseq ``.pt`` of a 64-wide model (the narrowest whose
    layers quantize). Activation codes flip where the float paths differ
    (``test_int8_model_matches_jax``), so each metric is held to JAX's
    int8 one within the distance JAX's own quantization moves it (JAX
    int8 vs JAX float); the float runs agree exactly, and the int8 run's
    transcripts are not the float run's (the flag quantized)."""
    saved = (Offsets.PAD, Offsets.GO, list(Offsets.VALUES))
    letters = (corpus / "dict.ltr.txt").read_text().splitlines()
    cfg = PortConfig(num_labels=4 + len(letters), d_model=64, num_heads=2,
                     num_layers=1, d_ff=128, timestep_masking=0.0,
                     channel_masking=0.0)
    ckpt = str(tmp_path / "ctc.pt")
    save_fairseq_ctc(Wav2Vec2AcousticModel(
        cfg, generator=torch.Generator().manual_seed(3)), ckpt)
    common = ["--checkpoint", ckpt, "--root_dir", str(corpus),
              "--valid_dataset", "valid.tsv", "--d_model", "64",
              "--num_heads", "2", "--num_layers", "1", "--d_ff", "128",
              "--pad_to_multiple", "4000", "--target_tokens_per_batch",
              "40000"]
    flt, q8 = (), ("--quantize", "int8")
    try:
        ours = {q: test_cli.evaluate(common + list(q) + ["--device", "cpu"],
                                     keep_outputs=True) for q in (flt, q8)}
        theirs = {q: jax_evaluate(common + list(q) + ["--lane_align",
                                                      "false"])
                  for q in (flt, q8)}
    finally:
        Offsets.PAD, Offsets.GO = saved[:2]
        Offsets.VALUES[:] = saved[2]
    assert set(theirs[q8]) == {"cer", "wer", "step"}
    assert {k: ours[flt][k] for k in theirs[flt]} == theirs[flt]
    for k in ("cer", "wer"):
        assert abs(ours[q8][k] - theirs[q8][k]) <= abs(
            theirs[q8][k] - theirs[flt][k]), k
    assert ours[q8]["step"] == theirs[q8]["step"]
    assert [o["greedy"] for o in ours[q8]["outputs"]] != \
        [o["greedy"] for o in ours[flt]["outputs"]]
