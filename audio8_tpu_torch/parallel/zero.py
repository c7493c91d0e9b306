"""ZeRO-1 and FSDP over the data-parallel ranks: the state-sharding half
of ``audio8_tpu/parallel/sharding.py`` (``zero1_shardings``,
``fsdp_shardings``, ``shard_state``, ``to_host``) and the JAX trainers'
``--zero1`` and ``--fsdp`` (which implies ``--zero1``).

In JAX both are layouts of one global program: the step computes the
numbers of the replicated step, and XLA inserts the gathers and
reduce-scatters. Here they are explicit, on the data-parallel ranks
of ``parallel/sharding.py``, and the numbers are those of the
data-parallel step too (the gradient sums, the update's elementwise
arithmetic; only the global norm's float64 sums are grouped otherwise).

Layout. A *segment* is a list of float32 leaves laid end to end in one
flat buffer, each leaf at a multiple of :data:`ALIGN` elements (the CUDA
allocator's 512 bytes, so a leaf's view is aligned as its own tensor
was), the buffer padded to a multiple of ``world * ALIGN``. Rank ``r``
owns the contiguous chunk ``[r * c, (r + 1) * c)``. The padding and the
gaps hold zeros; their gradients are zero, so AdamW and SGD leave them
zero. The JAX choice of "the first axis the data extent divides" is the
TPU's layout, not its semantics.

- **ZeRO-1** (:class:`StateShards` with ``mode="zero1"``): one segment
  over every parameter. The model's parameters become views of the
  whole flat buffer; every rank keeps whole parameters and whole
  gradients, and only the AdamW moments are chunks. The update
  reduce-scatters the gradients into the rank's chunk, runs kernel 5 on
  that chunk (one leaf crossing the leaves' boundaries, its tail the
  padding: ``ops/adamw.py`` is elementwise) and all-gathers the chunk
  into every rank's parameters. Under SGD there are no moments, and
  nothing is sharded.
- **FSDP** (:class:`ModuleShards`, ``mode="fsdp"``): one segment per
  layer *unit* (each encoder, decoder, text-encoder and predictor layer)
  and one for the rest (the *root*). Parameters, gradients and moments
  exist only as the rank's chunks; each ``nn.Parameter`` keeps its name
  and place in the model but holds no elements. A unit's forward
  gathers its segment (an all-gather), binds views of it in its
  modules, runs, and unbinds: the gathered buffer is freed with the
  call. The root is gathered for a whole step (:func:`gathered`, which
  the step factories enter), forward and backward.

The trap, and the answer. Autograd keeps every tensor an operation saves
for its backward: a layer's weights (``F.linear``, the custom ops of
kernels 3, 3b, 3c, 6 and 6b). Were the gathered views saved as they
are, the whole model would stay gathered until the backward. A unit's
forward therefore runs under ``torch.autograd.graph.saved_tensors_hooks``
that pack a tensor lying in the unit's gathered buffer as (segment,
offset, size, stride), not as the tensor, and unpack it by gathering the
segment again (once per backward: the gathered buffer is cached until
the segment's gather node runs its backward, which reduce-scatters the
segment's gradient into the rank's chunk gradient). Under ``--remat``
the layer runs inside ``torch.utils.checkpoint``, whose own hooks keep
nothing; the recompute gathers the unit again as a forward does.

Whole state where whole state is read: :func:`full_state`, the
counterpart of ``to_host``, gathers the parameters and moments of
sharded states and modules for its block on every rank (a collective),
so a checkpoint holds what the data-parallel run's holds.

Nothing here wraps the model in ``DistributedDataParallel`` or torch's
FSDP: they average, and they do not expect the zero gradients a frozen
leaf gets (``train/steps.py:_take_grads``) nor the summed gradients the
``global_sum`` terms need. With no process group, or one rank,
:func:`shard_state` shards nothing and a step is the plain one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from audio8_tpu_torch.parallel.sharding import (all_gather_flat,
                                                reduce_scatter_sum,
                                                shard_route, world_of)

logger = logging.getLogger("audio8_tpu_torch")

ALIGN = 128  # elements: every leaf's offset in a flat buffer (512 bytes)

# a module whose qualified name ends so is an FSDP unit: the encoder's
# layers, the text encoder's and decoder's ``layer_{i}``, the
# predictor's ``rnn_{i}``
_UNIT = re.compile(r"(^|\.)(layers\.\d+|layer_\d+|rnn_\d+)$")
# parameters of a unit that its stack reads outside the unit's forward
# stay in the root: WavLM's bucket table, from which the stack computes
# the bias every layer shares before its first layer runs
_ROOT_HELD = re.compile(r"\.rel_attn_embed\.")

_ATTR = "_a8t_shards"  # the ModuleShards of an FSDP-sharded module


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass
class Segment:
    """Leaves laid end to end in one padded flat buffer (module
    docstring): their positions among the state's leaves, shapes, sizes
    and offsets, the buffer's length and each rank's chunk length."""

    index: List[int]
    shapes: List[torch.Size]
    sizes: List[int]
    offsets: List[int]
    padded: int
    chunk: int

    @classmethod
    def of(cls, index: Sequence[int], tensors: Sequence[torch.Tensor],
           world: int) -> "Segment":
        offsets, n = [], 0
        for t in tensors:
            offsets.append(n)
            n += _round_up(t.numel(), ALIGN)
        padded = _round_up(max(n, 1), world * ALIGN)
        return cls(list(index), [t.shape for t in tensors],
                   [t.numel() for t in tensors], offsets, padded,
                   padded // world)

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The leaves (in this segment's order) as one zero-padded f32
        buffer."""
        flat = torch.zeros(self.padded, dtype=torch.float32,
                           device=tensors[0].device)
        for t, o, n in zip(tensors, self.offsets, self.sizes):
            flat[o:o + n].copy_(t.detach().reshape(-1))
        return flat

    def split_sizes(self) -> List[int]:
        """Leaf, gap, leaf, gap, ..., tail: ``flat.split`` of these gives
        every leaf at ``2 * j`` (one cat in the backward)."""
        sizes = []
        for j, (o, n) in enumerate(zip(self.offsets, self.sizes)):
            end = self.offsets[j + 1] if j + 1 < len(self.sizes) \
                else self.padded
            sizes += [n, end - o - n]
        return sizes

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf's view of a whole buffer of this segment."""
        parts = flat.split(self.split_sizes())
        return [parts[2 * j].view(s) for j, s in enumerate(self.shapes)]

    def pieces(self, rank: int) -> List[Tuple[int, int, int]]:
        """``(leaf, lo, hi)``: the part ``[lo, hi)`` of rank ``rank``'s
        chunk that holds leaf ``self.index[leaf]``'s elements (a leaf
        meets a chunk in one interval or not at all)."""
        c0, c1 = rank * self.chunk, (rank + 1) * self.chunk
        out = []
        for j, (o, n) in enumerate(zip(self.offsets, self.sizes)):
            lo, hi = max(o, c0), min(o + n, c1)
            if lo < hi:
                out.append((j, lo - c0, hi - c0))
        return out


class ShardGrads(dict):
    """Gradients as each segment's chunk on this rank (segment -> chunk
    tensor), already summed over the ranks: what an FSDP backward leaves
    and what a ZeRO-1 reduce-scatter makes."""


class _GatherSegment(torch.autograd.Function):
    """A segment's whole buffer from the rank's chunk (all-gather);
    backward: its gradient reduce-scattered into the chunk's (summed)."""

    @staticmethod
    def forward(ctx, chunk, shards, s):
        ctx.shards, ctx.s = shards, s
        return all_gather_flat(chunk.detach(), shards.group)

    @staticmethod
    def backward(ctx, grad):
        ctx.shards._regathered.pop(ctx.s, None)
        return reduce_scatter_sum(grad, ctx.shards.group), None, None


@dataclasses.dataclass(frozen=True)
class _Saved:
    """A saved tensor that lay in a unit's gathered buffer."""

    s: int
    offset: int
    size: torch.Size
    stride: Tuple[int, ...]


class ModuleShards:
    """A module's parameters under FSDP (module docstring): segment 0 the
    root, then one per unit, in ``named_parameters`` order within each;
    ``chunks[s]`` the rank's chunk of segment ``s`` (a leaf tensor that
    requires grad when any of its parameters does). Built from the
    module's whole parameters, which it then empties."""

    def __init__(self, module: nn.Module, group):
        self.group = group
        self.rank, self.world = dist.get_rank(group), world_of(group)
        named = list(module.named_parameters())
        self.names = [n for n, _ in named]
        self.params = dict(named)
        for n, p in named:
            if p.dtype != torch.float32:
                raise TypeError(f"FSDP: {n} is {p.dtype}, want float32")
        # every (module, attribute) that holds each parameter (ties too)
        self.slots: Dict[str, list] = {n: [] for n in self.names}
        by_id = {id(p): n for n, p in named}
        for m in module.modules():
            for attr, p in m._parameters.items():
                if p is not None and id(p) in by_id:
                    self.slots[by_id[id(p)]].append((m, attr))
        units = []
        for name, m in module.named_modules():
            if _UNIT.search(name) and not any(
                    name.startswith(u + ".") for u, _ in units):
                units.append((name, m))
        owner = []
        for n in self.names:
            s = 0
            if not _ROOT_HELD.search("." + n):
                for i, (u, _) in enumerate(units):
                    if n.startswith(u + "."):
                        s = i + 1
                        break
            owner.append(s)
        self.segments: List[Segment] = []
        self.chunks: List[torch.Tensor] = []
        for s in range(len(units) + 1):
            index = [i for i, o in enumerate(owner) if o == s]
            leaves = [named[i][1] for i in index]
            if not leaves:  # a unit without parameters: nothing to shard
                self.segments.append(None)
                self.chunks.append(None)
                continue
            seg = Segment.of(index, leaves, self.world)
            flat = seg.flatten(leaves)
            chunk = flat[self.rank * seg.chunk:
                         (self.rank + 1) * seg.chunk].clone()
            chunk.requires_grad_(any(p.requires_grad for p in leaves))
            self.segments.append(seg)
            self.chunks.append(chunk)
        with torch.no_grad():
            for p in self.params.values():
                p.data = p.data.new_empty(0)
        self._bound: set = set()
        self._live: Dict[int, int] = {}
        self._regathered: Dict[int, torch.Tensor] = {}
        self.materialized = False
        for i, (_, m) in enumerate(units):
            if self.segments[i + 1] is not None:
                self._wrap(m, i + 1)
        self._wrap(module, 0)
        setattr(module, _ATTR, self)
        shard_route(group)

    # ----------------------------------------------------- gather, bind

    def _wrap(self, m: nn.Module, s: int) -> None:
        orig = m.forward
        if s == 0:
            def forward(*args, **kwargs):
                return self._root_forward(orig, *args, **kwargs)
        else:
            def forward(*args, **kwargs):
                return self._unit_forward(s, orig, *args, **kwargs)
        m.forward = forward

    def _gather(self, s: int, autograd: bool) -> torch.Tensor:
        chunk = self.chunks[s]
        if autograd and chunk.requires_grad and torch.is_grad_enabled():
            return _GatherSegment.apply(chunk, self, s)
        with torch.no_grad():
            return all_gather_flat(chunk, self.group)

    def _bind(self, s: int, full: torch.Tensor) -> None:
        seg = self.segments[s]
        for j, v in zip(seg.index, seg.views(full)):
            name = self.names[j]
            if not self.params[name].requires_grad:
                v = v.detach()
            for m, attr in self.slots[name]:
                m._parameters[attr] = v
        self._bound.add(s)

    def _unbind(self, s: int) -> None:
        for j in self.segments[s].index:
            name = self.names[j]
            for m, attr in self.slots[name]:
                m._parameters[attr] = self.params[name]
        self._bound.discard(s)

    def _root_forward(self, orig, *args, **kwargs):
        if 0 in self._bound:
            return orig(*args, **kwargs)
        if torch.is_grad_enabled() and self.chunks[0].requires_grad:
            raise RuntimeError("FSDP: a forward that records gradients "
                               "runs inside zero.gathered(model), which "
                               "keeps the root gathered for its backward")
        with self.gathered():
            return orig(*args, **kwargs)

    def _unit_forward(self, s: int, orig, *args, **kwargs):
        from audio8_tpu_torch.nn.transformer import in_remat

        if s in self._bound:
            return orig(*args, **kwargs)
        grad = torch.is_grad_enabled() and self.chunks[s].requires_grad
        full = self._gather(s, grad)
        self._bind(s, full)
        try:
            if not grad or in_remat():
                return orig(*args, **kwargs)
            ptr = full.untyped_storage().data_ptr()
            self._live[ptr] = s
            try:
                with torch.autograd.graph.saved_tensors_hooks(
                        self._pack, self._unpack):
                    return orig(*args, **kwargs)
            finally:
                del self._live[ptr]
        finally:
            self._unbind(s)

    def _pack(self, t: torch.Tensor):
        s = self._live.get(t.untyped_storage().data_ptr()) \
            if t.layout == torch.strided else None
        if s is None or t.dtype != torch.float32:
            return t
        return _Saved(s, t.storage_offset(), t.size(), t.stride())

    def _unpack(self, x):
        if not isinstance(x, _Saved):
            return x
        full = self._regathered.get(x.s)
        if full is None:
            with torch.no_grad():
                full = all_gather_flat(self.chunks[x.s], self.group)
            self._regathered[x.s] = full
        return full.as_strided(x.size, x.stride, x.offset)

    @contextlib.contextmanager
    def gathered(self, whole: bool = False):
        """The root segment gathered and bound for the block (its gradient
        reduce-scattered when a backward reaches it); ``whole``: every
        segment, without autograd (decoding, whose loops call a layer's
        other methods). Reentrant; every rank must enter it."""
        todo = range(len(self.segments)) if whole else (0,)
        todo = [s for s in todo if self.segments[s] is not None
                and s not in self._bound]
        for s in todo:
            self._bind(s, self._gather(s, autograd=not whole))
        try:
            yield
        finally:
            for s in todo:
                self._unbind(s)
            if todo:
                self._regathered.clear()

    @contextlib.contextmanager
    def materialize(self):
        """Whole parameters in the module's own ``nn.Parameter`` objects
        for the block (a checkpoint's ``state_dict``), emptied after."""
        if self.materialized:
            yield
            return
        with torch.no_grad():
            for s, seg in enumerate(self.segments):
                if seg is None:
                    continue
                full = all_gather_flat(self.chunks[s], self.group)
                for j, v in zip(seg.index, seg.views(full)):
                    self.params[self.names[j]].data = v
        self.materialized = True
        try:
            yield
        finally:
            self.materialized = False
            with torch.no_grad():
                for p in self.params.values():
                    p.data = p.data.new_empty(0)

    # ------------------------------------------------------- gradients

    def take_grads(self) -> ShardGrads:
        """Each segment's chunk gradient (zeros where none arrived: a
        frozen or unused segment), the ``.grad`` fields cleared."""
        out = ShardGrads()
        for s, c in enumerate(self.chunks):
            if c is None:
                continue
            out[s] = torch.zeros_like(c) if c.grad is None else c.grad
            c.grad = None
        return out

    def tensors(self) -> List[torch.Tensor]:
        """The rank's chunks, one per segment (the EMA's operands)."""
        return [c for c in self.chunks if c is not None]


def module_shards(module: nn.Module) -> Optional[ModuleShards]:
    """The FSDP shards of ``module``, None when it is not sharded."""
    return getattr(module, _ATTR, None)


def sharded_tensors(module: nn.Module) -> List[torch.Tensor]:
    """The tensors that hold ``module``'s parameters on this rank: its
    FSDP chunks, else its parameters."""
    shards = module_shards(module)
    return shards.tensors() if shards is not None \
        else list(module.parameters())


def gathered(*modules: nn.Module, whole: bool = False):
    """:meth:`ModuleShards.gathered` of each FSDP-sharded module (nothing
    for the others): the step factories run a step's forward and backward,
    and an evaluation, in it."""
    stack = contextlib.ExitStack()
    for m in modules:
        shards = module_shards(m)
        if shards is not None:
            stack.enter_context(shards.gathered(whole))
    return stack


class StateShards:
    """A :class:`~audio8_tpu_torch.train.optim.TrainState`'s sharding:
    ``mode`` ``zero1`` (one segment; the model's parameters are views of
    ``flat``) or ``fsdp`` (``module`` the model's :class:`ModuleShards`).
    The state's optimizer moments are then one chunk per segment."""

    def __init__(self, state, group, mode: str):
        self.group, self.mode = group, mode
        self.rank, self.world = dist.get_rank(group), world_of(group)
        self.route = shard_route(group)
        self.n_leaves = len(state.names)
        whole_mu = getattr(state.opt_state, "mu", None)
        whole_nu = getattr(state.opt_state, "nu", None)
        if mode == "zero1":
            seg = Segment.of(range(self.n_leaves), state.params, self.world)
            self.flat = seg.flatten(state.params)
            with torch.no_grad():
                for p, v in zip(state.params, seg.views(self.flat)):
                    p.data = v
            self.segments = [seg]
            self.module = None
        elif mode == "fsdp":
            self.module = ModuleShards(state.model, group)
            if self.module.names != list(state.names):
                raise RuntimeError("FSDP: the model's parameters are not "
                                   "the state's")
            self.segments = [s for s in self.module.segments
                             if s is not None]
        else:
            raise ValueError(f"mode {mode!r}: zero1 or fsdp")
        if whole_mu is not None:
            state.opt_state.mu = [self._chunk_of(seg, whole_mu)
                                  for seg in self.segments]
            state.opt_state.nu = [self._chunk_of(seg, whole_nu)
                                  for seg in self.segments]
        logger.info("%s over %d ranks (%s collectives): %d segments, this "
                    "rank's chunks %d of %d elements", mode, self.world,
                    self.route, len(self.segments),
                    sum(s.chunk for s in self.segments),
                    sum(s.padded for s in self.segments))

    def _chunk_of(self, seg: Segment, leaves: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
        flat = seg.flatten([leaves[i] for i in seg.index])
        return flat[self.rank * seg.chunk:
                    (self.rank + 1) * seg.chunk].clone()

    def params(self) -> List[torch.Tensor]:
        """The tensors the update writes: this rank's chunk of each
        segment (views of ``flat`` under ZeRO-1)."""
        if self.mode == "zero1":
            c = self.segments[0].chunk
            return [self.flat[self.rank * c:(self.rank + 1) * c]]
        return self.module.tensors()

    def reduce_grads(self, grads, names: Sequence[str]) -> ShardGrads:
        """The step's gradients summed over the ranks as this rank's
        chunks. ZeRO-1: ``grads`` are whole (by name or in ``names``
        order) and are reduce-scattered; FSDP: they are the chunks the
        backward reduce-scattered already."""
        if self.mode == "fsdp":
            if not isinstance(grads, ShardGrads):
                raise TypeError("FSDP: the gradients are not the chunks a "
                                "sharded backward leaves")
            return grads
        if isinstance(grads, dict):
            grads = [grads[n] for n in names]
        flat = self.segments[0].flatten(list(grads))
        return ShardGrads({0: reduce_scatter_sum(flat, self.group)})

    def chunk_list(self, grads) -> List[torch.Tensor]:
        if not isinstance(grads, ShardGrads):
            raise TypeError(f"{self.mode}: apply_gradients wants the "
                            "reduced chunks (TrainState.reduce_grads)")
        return [grads[k] for k in sorted(grads)]

    def global_norm(self, chunks: Sequence[torch.Tensor]) -> torch.Tensor:
        """optax.global_norm of the whole gradient from the chunks: each
        leaf's sum of squares in float64 over the pieces this rank holds,
        summed over the ranks, then ``sqrt(sum over leaves)`` as
        ``optim.global_norm`` takes it (the float64 guard included)."""
        dev = chunks[0].device
        sums = torch.zeros(self.n_leaves, dtype=torch.float64, device=dev)
        idx, vals = [], []
        for seg, g in zip(self.segments, chunks):
            for j, lo, hi in seg.pieces(self.rank):
                idx.append(seg.index[j])
                vals.append(torch.linalg.vector_norm(
                    g[lo:hi], dtype=torch.float64).square())
        if vals:
            sums[torch.tensor(idx, device=dev)] = torch.stack(vals)
        dist.all_reduce(sums, group=self.group)
        return torch.linalg.vector_norm(torch.sqrt(sums)).float()

    def after_update(self) -> None:
        """ZeRO-1: every rank's updated chunk into every rank's whole
        parameters (an all-gather); FSDP keeps the chunks."""
        if self.mode == "zero1":
            chunk = self.params()[0].clone()
            all_gather_flat(chunk, self.group, out=self.flat)

    @contextlib.contextmanager
    def whole(self, state):
        """The state's whole parameters and moments for the block (every
        rank: a collective), as the data-parallel state holds them."""
        from audio8_tpu_torch.train.optim import AdamWState

        opt = state.opt_state
        ctx = self.module.materialize() if self.module is not None \
            else contextlib.nullcontext()
        with ctx:
            if not isinstance(opt, AdamWState):
                yield
                return
            mu = [None] * self.n_leaves
            nu = [None] * self.n_leaves
            with torch.no_grad():
                for seg, m, v in zip(self.segments, opt.mu, opt.nu):
                    for dst, chunk in ((mu, m), (nu, v)):
                        full = all_gather_flat(chunk, self.group)
                        for j, leaf in zip(seg.index, seg.views(full)):
                            dst[j] = leaf
            state.opt_state = AdamWState(opt.count, mu, nu)
            try:
                yield
            finally:
                state.opt_state = opt

    def stored(self, state) -> Dict[str, int]:
        """Elements this rank keeps between steps: parameters (the model's
        tensors and the chunks), moments and gradient storage."""
        opt = state.opt_state
        moments = sum(m.numel() for m in getattr(opt, "mu", [])) + \
            sum(v.numel() for v in getattr(opt, "nu", []))
        if self.mode == "zero1":
            return {"params": self.flat.numel(), "moments": moments,
                    "grads": 0}
        model = sum(p.numel() for p in self.module.params.values())
        return {"params": model + sum(c.numel() for c in
                                      self.module.tensors()),
                "moments": moments,
                "grads": sum(c.grad.numel() for c in self.module.tensors()
                             if c.grad is not None)}


def shard_state(state, group, zero1: bool = False,
                fsdp: bool = False) -> Optional[StateShards]:
    """Shard a whole :class:`~audio8_tpu_torch.train.optim.TrainState`
    (restored, every rank alike: after ``sync_from_rank0``) over
    ``group``'s ranks, the counterpart of the JAX ``shard_state``:
    ``fsdp`` (implies ``zero1``) the parameters, gradients and moments,
    ``zero1`` the AdamW moments. Nothing is sharded without a group, at
    one rank, without either flag, or under ZeRO-1 without moments (SGD).
    Returns the state's :class:`StateShards` (also ``state.shards``)."""
    from audio8_tpu_torch.train.optim import AdamWState

    if not (zero1 or fsdp) or group is None or world_of(group) == 1:
        return None
    if not fsdp and not isinstance(state.opt_state, AdamWState):
        logger.info("--zero1 with %s: no optimizer moments to shard",
                    state.tx.optim)
        return None
    state.shards = StateShards(state, group, "fsdp" if fsdp else "zero1")
    return state.shards


def shard_like(module: nn.Module, state) -> None:
    """Shard ``module`` (data2vec's EMA teacher, a copy of the student)
    as ``state``'s model is: its own FSDP units under FSDP; under
    ZeRO-1 or none it stays whole, as the student's parameters do."""
    shards = getattr(state, "shards", None)
    if shards is not None and shards.mode == "fsdp":
        ModuleShards(module, shards.group)


@contextlib.contextmanager
def full_state(*objs):
    """The whole state of each sharded ``TrainState`` (parameters and
    moments) and module (parameters) in ``objs`` for the block, the
    counterpart of the JAX ``to_host``: a checkpoint's writer, the
    SIGTERM save and a test read the data-parallel run's state. A
    collective: every rank enters it, in the same order. Unsharded
    objects pass through."""
    with contextlib.ExitStack() as stack:
        for obj in objs:
            shards = getattr(obj, "shards", None)
            if shards is not None:
                stack.enter_context(shards.whole(obj))
            elif isinstance(obj, nn.Module) and module_shards(obj):
                stack.enter_context(module_shards(obj).materialize())
        yield
