"""Mixture-of-Experts FFN of the port (``audio8_tpu/nn/moe.py:MoEFFN``).

Switch (top-1) or GShard (top-2) routing with a fixed per-expert
capacity ``min(max(ceil(k * S * capacity_factor / E), 1), S)`` over all
S = B * T tokens of the batch, padded frames included, so a row's output
can depend on the rows batched with it (as in JAX). The router is a
bias-free ``Dense(E)`` in float32 under any compute dtype, then a
softmax. Each of the k passes takes the argmax (a tie goes to the first
expert), numbers the tokens that chose each expert in row-major (B, T)
order after the slots earlier passes kept, keeps those below the
capacity with the chosen expert's un-renormalised probability as gate,
and masks the expert out for the next pass. Under top-2 a token's kept
gates are divided by their sum where it is positive; a token with
nothing kept outputs exactly 0 (no ``bo``): the residual carries it.

JAX dispatches and combines with one-hot einsums over (S, E, C); the
port gathers instead (:func:`dispatch`, :func:`combine`), which is the
same arithmetic (a dispatch slot is one ``x * 1.0``) without the
2 * S * E * C * d products of each einsum. No shape depends on the
data and nothing reads a value on the host, so the layer exports (the
capacity a symbolic expression of the batch) and can be captured. The expert products are ``torch.bmm`` (JAX leaves the layer
to XLA): ``h = gelu(x_e @ wi + bi)`` and ``y_e = h @ wo + bo``, below
float32 each product rounded before its bias is added with a second
rounding, as the dense ``Dense`` does. The combine sums each token's
gate * y_e products in float32 and rounds once to the compute dtype.
Below float32 that is bitwise XLA's contraction (the products of bf16
values are exact). In float32 under top-2, XLA's CPU contraction fuses
the second product into the sum as an FMA at some shapes (d 64) and
adds two rounded products at others (d 16, and d 96 over 4 080
tokens); the port adds two rounded products, one ulp of the output
from the fused form at most.

The Switch load-balance loss ``E * sum_e mean(top1 one-hot)_e *
mean(probs)_e`` (eq. 4) is returned beside the output; the stack hands
it to the active :class:`AuxLosses` (the JAX ``sow`` into ``losses``).

In a data-parallel step (``parallel/sharding.py``) a rank holds a block
of the global batch's rows, and the layer computes the global batch's
routing for them: the capacity counts the global tokens, each expert's
slots are numbered in the global row-major order (this rank's tokens
start after the earlier ranks' choices of that expert: one exchange of
E counts per pass), and the aux's means are the global batch's (summed
over the ranks with an identity backward). A token is kept where its
global slot is below the capacity; the rank's expert table holds only
its own kept tokens, in their order, so it has ``min(capacity, S_local)``
rows per expert and the expert products do a rank's share of the work.
The hidden-layer dropout of the JAX module has rate 0 in every model
(no model passes ``ffn_dropout_rate``), so the port has none and draws
no seed.
"""
from __future__ import annotations

import math
import threading
from typing import List, Tuple

import torch
from torch import nn

from audio8_tpu_torch.nn.layers import Dense, gelu
from audio8_tpu_torch.parallel.sharding import (active_group, global_sum,
                                                rank_prefix, world_of)


def capacity(tokens: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert, the JAX module's Python arithmetic. Under
    ``torch.export`` with a symbolic batch, ``tokens`` is a ``SymInt``
    and the same float arithmetic stays symbolic, its ceiling as the
    truncation plus one where the two differ (the value is positive, and
    ``math.ceil`` is no operator a saved program can hold), so an entry
    serves any batch size with the capacity the live model computes for
    it."""
    slots = top_k * tokens * capacity_factor / num_experts
    if isinstance(tokens, int):
        return min(max(int(math.ceil(slots)), 1), tokens)
    whole = math.trunc(slots)
    cap = torch.sym_ite(slots > whole, whole + 1, whole)
    return torch.sym_min(torch.sym_max(cap, 1), tokens)


def _token_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the tokens (dim 0), the global batch's in a
    data-parallel step."""
    return global_sum(x.sum(0)) / (x.shape[0] * world_of(active_group()))


def load_balance_loss(probs: torch.Tensor) -> torch.Tensor:
    """Switch eq. (4) over (S, E) router probabilities: E times the sum of
    each expert's top-1 token fraction times its mean probability."""
    e = probs.shape[-1]
    top1 = (probs.argmax(-1, keepdim=True)
            == torch.arange(e, device=probs.device)).float()
    return e * torch.sum(_token_mean(top1) * _token_mean(probs))


def route(probs: torch.Tensor, top_k: int, cap: int
          ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]],
                     List[torch.Tensor]]:
    """Top-k routing of (S, E) probabilities under ``cap`` slots per
    expert. Returns, per pass, each token's ``(expert, row)`` in the
    expert table of :func:`table_rows` rows (row ``table_rows(cap, S)``
    where it was dropped) and its combine weight (0 where dropped; under
    top-2 renormalised). In a data-parallel step a token is kept by its
    slot in the global batch's order, and the table holds this rank's
    kept tokens only."""
    s, e = probs.shape
    group = active_group()
    experts = torch.arange(e, device=probs.device)
    # per expert: the global batch's kept slots of the earlier passes,
    # and this rank's kept tokens (the same without a group)
    base = torch.zeros(e, dtype=torch.long, device=probs.device)
    rows = torch.zeros_like(base)
    dropped = table_rows(cap, s)
    masked = probs
    slots, weights = [], []
    for _ in range(top_k):
        idx = masked.argmax(-1)
        # (E, S): the count over tokens runs along the inner dim, where a
        # CUDA scan is fast (over the outer dim of (S, E) it took 0.78 ms
        # of a 2.3 ms layer on an H100 at S 4 440, E 8)
        onehot = (idx[None, :] == experts[:, None]).long()
        count = onehot.sum(1)
        # after the earlier ranks' tokens of each expert
        before, total = (rank_prefix(count, group) if group is not None
                         else (0, count))
        # each token's place among this rank's tokens of its expert
        order = (onehot.cumsum(1) - 1).gather(0, idx[None, :])[0]
        keep = order + (base + before)[idx] < cap
        row = order + rows[idx]
        gate = probs.gather(1, idx[:, None])[:, 0]
        weights.append(gate * keep)
        slots.append((idx, torch.where(keep, row,
                                       torch.full_like(row, dropped))))
        # the global batch's kept slots: base .. min(base + total, cap)
        base = torch.clamp(base + total, max=cap)
        rows = rows + (onehot * keep[None, :]).sum(1)
        masked = masked * (1.0 - onehot.t().float())
    if top_k == 2:
        tot = weights[0] + weights[1]
        safe = tot.clamp_min(1e-9)
        weights = [torch.where(tot > 0, w / safe, torch.zeros_like(w))
                   for w in weights]
    return slots, weights


def table_rows(cap: int, tokens: int) -> int:
    """Rows per expert of a rank's expert table: its kept tokens, at
    most the capacity and at most its ``tokens`` (a token takes an expert
    once); ``cap`` itself on one process (the capacity is at most the
    batch's tokens)."""
    return torch.sym_min(cap, tokens)


def dispatch(x: torch.Tensor, slots, num_experts: int,
             rows: int) -> torch.Tensor:
    """(S, d) tokens -> (E, rows, d) expert inputs by gathering each
    slot's token; an empty slot holds zeros."""
    s, d = x.shape
    table = torch.full((num_experts, rows + 1), s, dtype=torch.long,
                       device=x.device)
    tokens = torch.arange(s, device=x.device)
    for idx, pos in slots:
        # a dropped token writes the spare last column, which is cut
        table.index_put_((idx, pos), tokens)
    padded = torch.cat([x, x.new_zeros(1, d)])
    return padded[table[:, :rows]]


def combine(ye: torch.Tensor, slots, weights: List[torch.Tensor]
            ) -> torch.Tensor:
    """(E, rows, d) expert outputs -> (S, d): each token's gate-weighted
    sum over its slots in float32, rounded once to ``ye``'s dtype (a
    dropped slot reads a zero row with weight 0). The gates are rounded
    to the compute dtype first; below float32 their products with the
    outputs are exact in float32, so only the sum rounds."""
    e, _, d = ye.shape
    padded = torch.cat([ye, ye.new_zeros(e, 1, d)], dim=1)
    y = None
    for (idx, pos), w in zip(slots, weights):
        term = w.to(ye.dtype).float()[:, None] * padded[idx, pos].float()
        y = term if y is None else y + term
    return y.to(ye.dtype)


class MoEFFN(nn.Module):
    """Drop-in FFN: ``forward(x (B, T, d)) -> (y (B, T, d), aux)``.
    Parameters under the JAX names: ``router`` (a bias-free ``Dense``,
    float32), ``wi (E, d, f)``, ``bi (E, f)``, ``wo (E, f, d)``, ``bo (E,
    d)``, all float32 and cast to the compute dtype at use."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int = 8,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError(f"moe_top_k {top_k}: 1 (Switch) or 2 (GShard)")
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.compute_dtype = dtype
        self.router = Dense(d_model, num_experts, bias=False,
                            dtype=torch.float32)
        self.wi = nn.Parameter(torch.zeros(num_experts, d_model, d_ff))
        self.bi = nn.Parameter(torch.zeros(num_experts, d_ff))
        self.wo = nn.Parameter(torch.zeros(num_experts, d_ff, d_model))
        self.bo = nn.Parameter(torch.zeros(num_experts, d_model))

    def init_from(self, generator: torch.Generator) -> None:
        """flax ``lecun_normal`` on (E, in, out): the fan-in counts E, so
        the std is 1 / sqrt(E * in); zero biases. The router draws its
        own ``Dense`` init."""
        with torch.no_grad():
            for w in (self.wi, self.wo):
                e, fan_in, _ = w.shape
                w.copy_(torch.randn(w.shape, generator=generator,
                                    device=generator.device)
                        / math.sqrt(e * fan_in))
            self.bi.zero_()
            self.bo.zero_()

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, d = x.shape
        e, dt = self.num_experts, self.compute_dtype
        s = b * t
        # every rank holds as many tokens: the global batch's capacity
        cap = capacity(s * world_of(active_group()), e, self.top_k,
                       self.capacity_factor)
        xf = x.reshape(s, d)
        probs = torch.softmax(self.router(xf.float()), dim=-1)
        aux = load_balance_loss(probs)
        slots, weights = route(probs, self.top_k, cap)
        xe = dispatch(xf.to(dt), slots, e, table_rows(cap, s))
        h = gelu(torch.bmm(xe, self.wi.to(dt)) + self.bi.to(dt)[:, None])
        ye = torch.bmm(h, self.wo.to(dt)) + self.bo.to(dt)[:, None]
        return combine(ye, slots, weights).view(b, t, d), aux


class AuxLosses:
    """Collects the MoE layers' load-balance losses of one forward (the
    JAX ``losses`` collection): ``with AuxLosses() as aux: model(...)``,
    then :meth:`total`. Collections nest per thread; a layer records into
    the innermost, and outside any nothing is kept."""

    _local = threading.local()

    def __init__(self):
        self.values: List[Tuple[str, torch.Tensor]] = []

    @classmethod
    def _stack(cls) -> list:
        if not hasattr(cls._local, "stack"):
            cls._local.stack = []
        return cls._local.stack

    def __enter__(self) -> "AuxLosses":
        self._stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        self._stack().pop()

    def total(self, device=None) -> torch.Tensor:
        """The float32 sum from 0, in the sorted order of the layers'
        names, as ``jax.tree_util.tree_leaves`` orders the collection
        (``layer_1``, ``layer_11``, ``layer_3``, ...)."""
        if self.values:
            device = self.values[0][1].device
        out = torch.zeros((), dtype=torch.float32, device=device)
        for _, v in sorted(self.values, key=lambda kv: kv[0]):
            out = out + v
        return out


def record_aux(name: str, aux: torch.Tensor) -> None:
    """Hand a layer's aux loss to the innermost :class:`AuxLosses`."""
    stack = AuxLosses._stack()
    if stack:
        stack[-1].values.append((name, aux))
