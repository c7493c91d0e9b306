"""Tensor and sequence parallelism over a model group: the ``'model'``
half of ``audio8_tpu/parallel/sharding.py`` (``TP_RULES``) and of
``audio8_tpu/nn/transformer.py``'s ``seq_shard`` (``--tensor_parallel``,
``--sequence_parallel``), on the model groups of ``parallel/sharding.py``.

In JAX both are layouts of one global program on a ``('data',
'model')`` mesh: the parameters that ``TP_RULES`` selects are split over
``'model'``, XLA inserts the collectives, and the numbers are the
single-device program's. Here each rank of a model group holds its
slice of those parameters and the collectives are explicit, Megatron's:

- :data:`TP_RULES` are JAX's regexes, applied to the JAX path of each
  of the port's parameters (``models/convert.py:model_assignments``), so
  :func:`split_table` selects exactly the leaves JAX splits, with JAX's
  fallback: a leaf whose split axis the extent does not divide stays
  whole. Attention ``w_{Q,K,V}`` are split on their output and ``w_O``
  on its input: a rank owns the heads ``h0 .. h0 + H/tp - 1``; an FFN's
  ``expand`` on its output and ``contract`` on its input. Everything
  else is replicated;
- a *region* is the stretch between a column-split and a row-split
  product. It is entered by :func:`enter` (identity forward, all-reduce
  backward: the partial gradients of the rank's heads summed into the
  replicated input's) and left by :func:`leave` (all-reduce forward,
  identity backward), which adds the row-split product's bias once,
  after the sum, in the ``Dense`` rounding order (a bf16 product is
  rounded, summed, then the bias added). A replicated parameter used
  inside a region for the rank's heads only (a conformer's
  ``pos_bias_u``, WavLM's gate, a relative-position table) passes
  :func:`replicated`, the same identity with an all-reduce backward;
- under sequence parallelism (:class:`SeqRegion`, the transformer
  stack's ``run_layers``) the residual stream between layers is split on
  T over the model group: :func:`enter` all-gathers the frames
  (reduce-scatter backward) and :func:`leave` reduce-scatters them
  (all-gather backward). A T that ``tp`` does not divide is padded to a
  multiple inside the region; the padded frames are cut before the
  attention and after the stack, and draw no dropout (:func:`seq_dropout`
  draws the whole tensor's mask for the rank's real frames,
  ``ops/hashrand.py:strided_index``);
- every hash draw is the one the whole tensor gets: the attention
  kernels take the rank's first global head and the head count
  (``ops/attention.py``), the flat probability dropout and the
  sequence-parallel residual dropout a strided index (kernel 4).

The model groups' ranks hold the same rows, so losses, counts and the
data-parallel gradient sums use the data group (``parallel/sharding.py``).
The global norm sums the split leaves' squares over the model group and
counts the replicated ones once (:meth:`TensorShards.global_norm`).
Deviation from JAX: JAX accepts any width the extent divides, splitting a
head's columns if it must; here a rank owns whole heads, so
``num_heads`` and ``d_ff`` must be multiples of ``tp``
(:func:`shard_model` raises, naming the field). Checkpoints are written
whole (:meth:`TensorShards.whole`, entered by ``parallel/__init__.py:
full_state``) and read whole before the state is sliced.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from audio8_tpu_torch.parallel.sharding import (all_gather_flat,
                                                all_reduce_sum,
                                                reduce_scatter_sum)

logger = logging.getLogger("audio8_tpu_torch")

# ``audio8_tpu/parallel/sharding.py:TP_RULES`` over the JAX path of a
# leaf: its spec, one mesh axis (or None) per dimension of the JAX leaf
# (Dense kernels are (in, out)). First match wins; MoE experts are split
# on their leading axis (expert parallelism, not ported: refused beside
# tensor parallelism).
TP_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r".*self_attn/w_[QKV]/kernel$", (None, "model")),
    (r".*self_attn/w_[QKV]/bias$", ("model",)),
    (r".*self_attn/w_O/kernel$", ("model", None)),
    (r".*src_attn/w_[QKV]/kernel$", (None, "model")),
    (r".*src_attn/w_[QKV]/bias$", ("model",)),
    (r".*src_attn/w_O/kernel$", ("model", None)),
    (r".*ffn/expand/kernel$", (None, "model")),
    (r".*ffn/expand/bias$", ("model",)),
    (r".*ffn/contract/kernel$", ("model", None)),
    (r".*ffn/w[io]$", ("model",)),
    (r".*ffn/b[io]$", ("model",)),
    (r".*", ()),
]


def jax_spec(path: str) -> Tuple[Optional[str], ...]:
    """The first :data:`TP_RULES` spec whose regex matches ``path``."""
    for pattern, spec in TP_RULES:
        if re.match(pattern, path):
            return spec
    return ()


def split_table(model: nn.Module, tp: int) -> Dict[str, Optional[int]]:
    """Each state-dict entry of ``model`` -> the dimension of the port's
    tensor split over a model group of ``tp`` ranks, or None
    (replicated): :data:`TP_RULES` on the entry's JAX path, with JAX's
    ``_fixed_spec`` fallback to replication where ``tp`` does not divide
    the axis. A transposed leaf (Dense, conv kernels) maps JAX axis ``j``
    to the port's ``ndim - 1 - j``."""
    from audio8_tpu_torch.models.convert import (_conv, _t,
                                                 model_assignments)

    state = model.state_dict()
    table: Dict[str, Optional[int]] = {}
    for path, key, tf in model_assignments(model):
        shape = tuple(state[key].shape)
        reversed_axes = tf is _t or tf is _conv
        jax_shape = shape[::-1] if reversed_axes else shape
        dim = None
        for j, axis in enumerate(jax_spec("/".join(path))):
            if axis is not None and j < len(jax_shape) \
                    and jax_shape[j] % tp == 0:
                dim = len(shape) - 1 - j if reversed_axes else j
                break
        table[key] = dim
    return table


# ------------------------------------------------------------ the group


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """A model group, this rank's place in it and its size."""

    group: object
    rank: int
    size: int

    def __deepcopy__(self, memo):  # a copied module shares the group
        return self


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, ``(n, *x.shape)``."""
    return all_gather_flat(x.reshape(-1), group).view(n, *x.shape)


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's slice of ``x`` (``(n, *shape)``) summed over the
    group: ``(*shape)``."""
    return reduce_scatter_sum(x.reshape(-1), group).view(x.shape[1:])


# --------------------------------------------- the region's collectives


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated tensor entering
    the rank's column-split products."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.mg.group), None


class _Leave(torch.autograd.Function):
    """All-reduce forward, identity backward: the rank's row-split partial
    product summed into the replicated output."""

    @staticmethod
    def forward(ctx, x, mg):
        return all_reduce_sum(x, mg.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _frames(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n * Tl, ...) -> (n, B, Tl, ...): the ranks' frame blocks
    first."""
    b, t = x.shape[:2]
    return x.reshape(b, n, t // n, *x.shape[2:]).transpose(0, 1)


def _unframes(x: torch.Tensor) -> torch.Tensor:
    """(n, B, Tl, ...) -> (B, n * Tl, ...)."""
    n, b, tl = x.shape[:3]
    return x.transpose(0, 1).reshape(b, n * tl, *x.shape[3:])


def _pad_t(x: torch.Tensor, t_pad: int) -> torch.Tensor:
    if x.shape[1] == t_pad:
        return x
    pad = [0, 0] * (x.dim() - 2) + [0, t_pad - x.shape[1]]
    return F.pad(x, pad)


def _gather_t(x, region) -> torch.Tensor:
    mg = region.mg
    return _unframes(_all_gather(x, mg.group, mg.size))[:, :region.t]


def _scatter_sum_t(x, region) -> torch.Tensor:
    mg = region.mg
    return _reduce_scatter(_frames(_pad_t(x, region.t_pad), mg.size),
                           mg.group)


def _own_t(x, region) -> torch.Tensor:
    lo = region.t0
    return _pad_t(x, region.t_pad)[:, lo:lo + region.t_local].contiguous()


class _GatherIn(torch.autograd.Function):
    """Sequence-parallel entry of a region: the frames all-gathered (the
    padding cut), reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, region):
        ctx.region = region
        return _gather_t(x, region)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_sum_t(grad, ctx.region), None


class _ScatterOut(torch.autograd.Function):
    """Sequence-parallel exit of a region: the partial products summed
    and scattered to the ranks' frames, all-gather backward."""

    @staticmethod
    def forward(ctx, x, region):
        ctx.region = region
        return _scatter_sum_t(x, region)

    @staticmethod
    def backward(ctx, grad):
        return _gather_t(grad, ctx.region), None


class _Split(torch.autograd.Function):
    """The replicated stream cut to the rank's frames at the stack's
    entry; backward, every rank's frames gathered (the replicated input's
    whole gradient)."""

    @staticmethod
    def forward(ctx, x, region):
        ctx.region = region
        return _own_t(x, region)

    @staticmethod
    def backward(ctx, grad):
        return _gather_t(grad, ctx.region), None


class _Join(torch.autograd.Function):
    """The ranks' frames gathered into the replicated stream at the
    stack's exit; backward, the rank's frames of the (replicated)
    gradient."""

    @staticmethod
    def forward(ctx, x, region):
        ctx.region = region
        return _gather_t(x, region)

    @staticmethod
    def backward(ctx, grad):
        return _own_t(grad, ctx.region), None


# ------------------------------------------------ sequence parallelism


@dataclasses.dataclass(frozen=True)
class SeqRegion:
    """A sequence-parallel stretch of the stack: T frames (``t_pad``
    padded) split over the model group, this rank's ``t_local`` starting
    at ``t0``, of which ``n_real`` are frames of the input."""

    mg: ModelGroup
    t: int
    t_pad: int
    t0: int
    t_local: int
    n_real: int

    @classmethod
    def of(cls, mg: ModelGroup, t: int) -> "SeqRegion":
        t_local = -(-t // mg.size)
        t0 = mg.rank * t_local
        return cls(mg, t, t_local * mg.size, t0, t_local,
                   min(max(t - t0, 0), t_local))

    def __deepcopy__(self, memo):
        return self


class _Current:
    region: Optional[SeqRegion] = None


_CURRENT = _Current()


@contextlib.contextmanager
def in_region(region: Optional[SeqRegion]):
    """Run the block with ``region`` as the sequence-parallel stretch that
    :func:`enter`, :func:`leave` and :func:`seq_dropout` read (also a
    recomputed layer's, which ``nn/transformer.py:run_layers`` replays
    inside it)."""
    saved = _CURRENT.region
    _CURRENT.region = region
    try:
        yield
    finally:
        _CURRENT.region = saved


def stack_region(layers, t: int,
                 sequence_parallel: bool) -> Optional[SeqRegion]:
    """The sequence-parallel stretch of a stack of T frames: None unless
    ``sequence_parallel`` and its layers are split over a model group."""
    if not sequence_parallel or not layers:
        return None
    mg = getattr(layers[0].self_attn, "tp", None)
    return None if mg is None else SeqRegion.of(mg, t)


def split_frames(x: torch.Tensor, region: SeqRegion) -> torch.Tensor:
    """The stack's replicated input cut to the rank's (padded) frames."""
    return _Split.apply(x, region)


def join_frames(x: torch.Tensor, region: SeqRegion) -> torch.Tensor:
    """The ranks' frames gathered into the whole (B, T, D) stream."""
    return _Join.apply(x, region)


# ---------------------------------------------------------- the region


def _region_for(mg: ModelGroup) -> Optional[SeqRegion]:
    region = _CURRENT.region
    return region if region is not None and region.mg is mg else None


def enter(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """``x`` entering the rank's split products: the identity (all-reduce
    backward), or under sequence parallelism the frames all-gathered."""
    region = _region_for(mg)
    if region is not None:
        return _GatherIn.apply(x, region)
    return _Enter.apply(x, mg)


def replicated(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """A replicated tensor used for the rank's heads only: the identity,
    its gradient summed over the model group."""
    return _Enter.apply(x, mg)


def dense_product(dense, x: torch.Tensor) -> torch.Tensor:
    """``x W^T`` of a ``Dense`` without its bias, in its compute dtype (a
    row-split layer's partial product)."""
    dt = dense.compute_dtype
    return F.linear(x.to(dt), dense.weight.to(dt))


def leave(y: torch.Tensor, bias: Optional[torch.Tensor],
          mg: ModelGroup) -> torch.Tensor:
    """The rank's partial product summed over the model group (or, under
    sequence parallelism, summed and scattered to the rank's frames),
    then ``bias`` added once, in the ``Dense`` order (``y``'s dtype)."""
    region = _region_for(mg)
    if region is not None:
        y = _ScatterOut.apply(y, region)
    else:
        y = _Leave.apply(y, mg)
    return y if bias is None else y + bias.to(y.dtype)


def seq_dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """The residual stream's dropout: ``nn.dropout.dropout``, and under
    sequence parallelism the whole (B, T, D) tensor's mask on the rank's
    real frames (one seed drawn on every rank; the padded frames draw
    nothing and pass unchanged)."""
    from audio8_tpu_torch.nn.dropout import dropout
    from audio8_tpu_torch.ops.dropout import fused_dropout
    from audio8_tpu_torch.ops.hashrand import draw_seed, strided_index
    from audio8_tpu_torch.parallel.sharding import row_offset

    region = _CURRENT.region
    if region is None:
        return dropout(x, rate, generator)
    if generator is None or rate == 0.0:
        return x
    seed = draw_seed(generator)
    n = region.n_real
    if n == 0:
        return x
    real = x[:, :n].contiguous()
    index = strided_index(real.shape, (x.shape[0], region.t) + x.shape[2:],
                          (row_offset(), region.t0) + (0,) * (x.dim() - 2))
    dropped = fused_dropout(real, rate, seed, *index)
    return dropped if n == x.shape[1] else torch.cat([dropped, x[:, n:]], 1)


# ------------------------------------------------------- the sharding


def _heads_modules():
    from audio8_tpu_torch.nn.conformer import ConformerAttention
    from audio8_tpu_torch.nn.transformer import MultiHeadAttention

    return (MultiHeadAttention, ConformerAttention)


def _chunk(t: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    return t.chunk(mg.size, dim)[mg.rank].contiguous().clone()


class TensorShards:
    """A model's parameters split over a model group (:func:`shard_model`):
    the split ones with their dimension; for a ``TrainState`` also its
    moments' (:func:`shard_state`)."""

    def __init__(self, mg: ModelGroup, split: List[Tuple[nn.Parameter, int]],
                 names: Dict[int, str], seq_names: Sequence[str] = ()):
        self.mg = mg
        self.split = split
        self.dims = {id(p): d for p, d in split}
        self.names = names
        # the replicated parameters of sequence-parallel layers: each rank
        # differentiates them through its frames only
        self.seq_names = tuple(seq_names)

    def __deepcopy__(self, memo):
        return self

    def dim_of(self, p: torch.Tensor) -> Optional[int]:
        return self.dims.get(id(p))

    def global_norm(self, grads: Sequence[torch.Tensor],
                    params: Sequence[torch.Tensor]) -> torch.Tensor:
        """``optax.global_norm`` of the whole gradient: the replicated
        leaves' squares once, the split leaves' summed over the model
        group (float64, as ``train/optim.py:global_norm``)."""
        dev = grads[0].device
        rep = torch.zeros((), dtype=torch.float64, device=dev)
        part = torch.zeros((), dtype=torch.float64, device=dev)
        for g, p in zip(grads, params):
            sq = torch.linalg.vector_norm(g, dtype=torch.float64) ** 2
            if id(p) in self.dims:
                part = part + sq
            else:
                rep = rep + sq
        part = all_reduce_sum(part, self.mg.group)
        return torch.sqrt(rep + part).float()

    def reduce_seq_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum the gradients of the sequence-parallel layers' replicated
        parameters (their norms, the biases added after a scatter) over
        the model group, in place: one all-reduce of one flat buffer."""
        ts = [grads[n] for n in self.seq_names if n in grads]
        if not ts:
            return
        flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in ts]),
                              self.mg.group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor of the rank's slice ``t`` split on ``dim``."""
        parts = _all_gather(t.detach(), self.mg.group, self.mg.size)
        return torch.cat(list(parts), dim)

    @contextlib.contextmanager
    def whole(self, state=None):
        """The whole parameters (and, given its ``TrainState``, moments)
        for the block, on every rank (a collective), then the rank's
        slices again: what a checkpoint writes."""
        saved = []
        with torch.no_grad():
            for p, d in self.split:
                saved.append((p, p.data))
                p.data = self.gather(p.data, d)
            moments = []
            opt = getattr(state, "opt_state", None)
            if opt is not None and hasattr(opt, "mu"):
                for i, p in enumerate(state.params):
                    d = self.dim_of(p)
                    if d is None:
                        continue
                    moments.append((i, opt.mu[i], opt.nu[i]))
                    opt.mu[i] = self.gather(opt.mu[i], d)
                    opt.nu[i] = self.gather(opt.nu[i], d)
        try:
            yield
        finally:
            for p, data in saved:
                p.data = data
            for i, mu, nu in moments:
                opt.mu[i], opt.nu[i] = mu, nu


def _configure(model: nn.Module, table: Dict[str, Optional[int]],
               mg: ModelGroup) -> None:
    """Tell each module whose parameters are split that it computes the
    rank's part: attention its heads (``num_heads`` the local count,
    ``heads_global`` and ``h0``), an FFN its hidden columns. Raises where
    a split would cut a head or an FFN column block unevenly, or reach an
    MoE layer."""
    from audio8_tpu_torch.nn.moe import MoEFFN
    from audio8_tpu_torch.nn.transformer import (FFN, TransformerDecoderStack,
                                                 TransformerEncoderLayer)

    tp = mg.size
    split = {k for k, d in table.items() if d is not None}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, MoEFFN):
            raise NotImplementedError(
                "--moe_experts beside --tensor_parallel > 1 (expert "
                "parallelism over the model group) is not ported yet: "
                "ROADMAP.md queue 1, item 8 (parallelism beyond DP)")
        if isinstance(m, _heads_modules()):
            names = [f"{prefix}{n}.weight" for n in m.proj_names]
            if not any(n in split for n in names):
                continue
            if m.num_heads % tp:
                raise ValueError(f"num_heads {m.num_heads} is not a multiple "
                                 f"of --tensor_parallel {tp}: a rank owns "
                                 "whole heads (ROADMAP.md section 3)")
            if not all(n in split for n in names):
                raise ValueError(f"{name}: only some projections split")
            m.heads_global = m.num_heads
            m.num_heads //= tp
            m.h0 = mg.rank * m.num_heads
            m.tp = mg
        ffn = None
        if isinstance(m, TransformerEncoderLayer) and m.moe is None:
            ffn = (m.fc1, m.fc2, "fc1", "fc2")
        elif isinstance(m, FFN):
            ffn = (m.expand, m.contract, "expand", "contract")
        if ffn is not None:
            expand, contract, en, cn = ffn
            if f"{prefix}{en}.weight" not in split and \
                    f"{prefix}{cn}.weight" not in split:
                d_ff = expand.weight.shape[0]
                if d_ff % tp:
                    raise ValueError(f"d_ff {d_ff} is not a multiple of "
                                     f"--tensor_parallel {tp}: a rank owns "
                                     "whole FFN column blocks (ROADMAP.md "
                                     "section 3)")
                continue
            m.ffn_tp = mg
        if isinstance(m, TransformerDecoderStack):
            if m.num_heads % tp:
                raise ValueError(f"num_heads {m.num_heads} is not a multiple "
                                 f"of --tensor_parallel {tp}")
            m.num_heads //= tp


def _frame_parameters(model: nn.Module) -> List[str]:
    """The replicated parameters that sequence parallelism differentiates
    through the rank's frames only: those of the layers of every
    transformer stack whose config asks for it (``nn/transformer.py:
    run_layers``), but the attention's own (its split projections, and
    the tables it uses for the rank's heads inside the region, which
    :func:`replicated` sums) other than the output projection's bias,
    added after the scatter."""
    heads = _heads_modules()
    out = []
    for name, m in model.named_modules():
        cfg = getattr(m, "config", None)
        if not (getattr(cfg, "sequence_parallel", False)
                and getattr(cfg, "encoder_type", "") == "transformer"
                and isinstance(getattr(m, "layers", None), nn.ModuleList)):
            continue
        inside = set()
        for a in m.layers.modules():
            if isinstance(a, heads):
                bias = getattr(a, a.proj_names[3]).bias
                inside |= {id(p) for p in a.parameters() if p is not bias}
        prefix = f"{name}.layers." if name else "layers."
        out += [prefix + n for n, p in m.layers.named_parameters()
                if id(p) not in inside]
    return out


def shard_model(model: nn.Module, mg: ModelGroup) -> TensorShards:
    """Split ``model`` (whole, every rank alike) over the model group: the
    :func:`split_table` leaves keep the rank's slice, the modules that
    own them compute the rank's part (:func:`_configure`). Returns the
    model's :class:`TensorShards` (also ``model.tensor_shards``)."""
    table = split_table(model, mg.size)
    _configure(model, table, mg)
    params = dict(model.named_parameters())
    split, names = [], {}
    with torch.no_grad():
        for key, dim in table.items():
            if dim is None or key not in params:
                continue
            p = params[key]
            p.data = _chunk(p.data, dim, mg)
            split.append((p, dim))
            names[id(p)] = key
    split_ids = {id(p) for p, _ in split}
    seq_names = [n for n in _frame_parameters(model)
                 if id(params[n]) not in split_ids]
    shards = TensorShards(mg, split, names, seq_names)
    model.tensor_shards = shards
    logger.info("tensor parallel: %d of %d parameters split over %d ranks",
                len(split), len(params), mg.size)
    return shards


def shard_state(state, mg: ModelGroup) -> TensorShards:
    """Split a whole ``TrainState`` (restored and broadcast) over the
    model group: its model (:func:`shard_model`) and, for AdamW, the
    moments of the split leaves. Sets ``state.tensor_shards``."""
    shards = shard_model(state.model, mg)
    opt = state.opt_state
    if hasattr(opt, "mu"):
        for i, p in enumerate(state.params):
            d = shards.dim_of(p)
            if d is not None:
                opt.mu[i] = _chunk(opt.mu[i], d, mg)
                opt.nu[i] = _chunk(opt.nu[i], d, mg)
    state.tensor_shards = shards
    return shards


def current_model_group() -> Optional[ModelGroup]:
    """This rank's model group as a :class:`ModelGroup`, None without
    tensor parallelism (``parallel/sharding.py:make_groups``)."""
    from audio8_tpu_torch.parallel.sharding import model_group

    group = model_group()
    if group is None:
        return None
    return ModelGroup(group, dist.get_rank(group), dist.get_world_size(group))
