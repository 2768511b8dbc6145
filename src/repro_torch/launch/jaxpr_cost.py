"""FLOP and byte accounting of a torch function, op by op: port of
``src/repro/launch/jaxpr_cost.py``.

The reference walks the jaxpr and multiplies each ``scan`` body by its trip
count.  The port has no jaxpr: :func:`cost_of` runs ``fn`` under
:class:`CostMode`, a ``TorchDispatchMode`` that sees every aten op the call
runs, usually on ``meta`` tensors (shapes only: nothing is allocated or
computed).  Python loops and ``torch.utils.checkpoint`` recompute run op
by op, so every trip and every recomputed op is counted as it runs: there
is nothing to multiply.

Conventions (the reference's, jaxpr_cost.py:8-18, 84-116):
  * FLOPs: a contraction 2·M·N·K·batch; elementwise 1/elem
    (transcendentals 4/elem); reductions 1/input-elem; cumulative ops
    1/output-elem; sorts and top-k n·log2 n over their input's n elements;
    data movement and dtype casts 0.
  * Bytes: per op, the sum of its tensor operands' and results' sizes (an
    *unfused* upper bound, as the reference's).
  * Shapes are GLOBAL: an op on DTensors is counted once, at the DTensor's
    global shapes, and the local ops DTensor runs for it are not counted
    again.  Ops on the local shards of :func:`~repro_torch.models.layers.
    on_local_shards` (attention and the recurrent cores under a policy),
    forward and backward, are scaled by the number of ranks that split that
    work, which gives their global count.  Per-device numbers divide by the
    device count, as the reference's do.

Contractions.  ``torch.einsum`` is counted as one op at its own level, as
the reference's ``jnp.einsum`` lowers to one ``dot_general`` a pair of
operands: 2·(product of every remaining label's size) FLOPs, after each
label that only one operand has and the output lacks is summed out first
(1/input-elem), and its operands' plus result's bytes.  The aten ops torch
lowers it to (``bmm``, or ``mul`` and ``sum``, with views and copies) are
not counted again.  Outside an einsum: ``mm``, ``bmm``, ``mv``, ``dot``
(and ``addmm``/``baddbmm``, plus 1/output-elem for their add), and
``convolution`` at 2·output-elems·(weight elems per output channel), the
reference's ``conv_general_dilated`` rule.

Composite aten ops get the FLOPs of the reference's decomposition of the
same function (n input elements, r rows of the reduced dim; measured with
the reference's counter on ``jax.nn``):
  ``_softmax`` 8n+r (max, sub, exp, sum, div); ``_log_softmax`` 8n+5r;
  ``logsumexp`` 7n+7r; ``mean`` n+r (sum, div); ``silu`` 5n (logistic,
  mul); ``gelu`` (tanh form) 11n; ``log_sigmoid_forward`` 16n;
  ``logaddexp`` and ``softplus`` 14n; ``pow`` by an integer 1n, else 4n;
  ``tril``/``triu`` 1n.  Backward ops, the reference's transposed JVPs:
  ``_softmax_backward_data`` 7n+4r, ``tanh_backward`` 4n,
  ``sigmoid_backward`` 3n, ``silu_backward`` 6n, ``gelu_backward`` 14n,
  ``log_sigmoid_backward`` 14n, ``threshold_backward`` 1n.
  ``masked_fill`` and ``where`` (``select_n``), comparisons, ``clamp``,
  ``sgn``, ``argmax``, ``_to_copy`` (``convert_element_type``),
  ``copy_`` and ``clone`` (``copy``, ``dynamic_update_slice``), ``index``,
  ``index_put``, ``gather``, ``scatter``, ``scatter_add`` and
  ``index_add`` (``gather``/``scatter``/``scatter-add``), ``cat``,
  ``stack``, ``constant_pad_nd``, ``flip`` and the factories (``zeros``,
  ``arange``, ...) are data movement: 0 FLOPs, their bytes.  Any other op
  is elementwise, 1/output-elem, the reference's default.

Views (``view``, ``_unsafe_view``, ``permute``, ``transpose``, ``expand``,
``unsqueeze``, ``squeeze``, ``slice``, ``select``, ``split``, ``unbind``,
``detach``, ``alias``, ...: every op whose result aliases an operand
without writing it) alias storage and move no bytes, so they are charged
none: the reference charges its ``reshape``/``transpose``/
``broadcast_in_dim`` eqns their operand and result bytes, so the port's
bytes run below the reference's by those.

Known departures from the reference:
  * a CUDA kernel that the port launches through ``ctypes`` is invisible
    to a dispatch mode, where the reference counts a ``pallas_call`` body
    once.  The dry run reaches none: it decodes with ``"sdpa"`` and trains
    with ``use_flash=False``.
  * the reference charges each ``sharding_constraint`` (its ``shard``
    sites) as elementwise, 1/elem, since it is not in ``ZERO_FLOP``
    (jaxpr_cost.py:36-44); the port's shard sites are redistributions,
    collectives of 0 FLOPs and bytes here, counted as traffic by
    ``hlo_analysis.collective_bytes``.

The same mode records each collective it sees (``hlo_analysis.
collective_record``), inside DTensor's own dispatch too, and tracks an
eager peak: the live bytes a device holds of every tensor created during
the call (each DTensor's local shard; outputs included, storage shared by
views counted once), an estimate of the temps an eager run allocates.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import hlo_analysis
from repro_torch.models import layers as L

TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "sin", "cos", "erf", "rsqrt", "sqrt",
}

# FLOPs an element of the result (or of the input, for the composites
# marked so below) of each composite op: the reference's decomposition
PER_ELEM = {
    "silu": 5, "gelu": 11, "log_sigmoid_forward": 16, "logaddexp": 14,
    "softplus": 14, "tril": 1, "triu": 1,
    "tanh_backward": 4, "sigmoid_backward": 3, "silu_backward": 6,
    "gelu_backward": 14, "log_sigmoid_backward": 14,
    "threshold_backward": 1,
}
# (per input element, per row of the reduced dim)
ROW_REDUCTIONS = {
    "_softmax": (8, 1), "_log_softmax": (8, 5), "logsumexp": (7, 7),
    "mean": (1, 1), "_softmax_backward_data": (7, 4),
}

ZERO_FLOP = {
    "masked_fill", "where", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "clamp",
    "clamp_min", "clamp_max", "sgn", "sign", "isfinite", "floor", "ceil",
    "round", "remainder", "fmod", "argmax", "argmin", "_to_copy", "copy",
    "copy_", "clone", "contiguous", "index", "index_put", "gather",
    "scatter", "scatter_add", "index_add", "index_select", "cat", "stack",
    "constant_pad_nd", "flip", "roll", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "empty", "empty_like", "empty_strided",
    "new_zeros", "new_ones", "new_full", "new_empty", "new_empty_strided",
    "arange", "scalar_tensor", "lift_fresh_copy", "fill",
    "zero", "slice_backward", "select_backward", "_local_scalar_dense",
    "detach", "isinf", "isnan", "wait_tensor",
}

REDUCTIONS = {"sum", "amax", "amin", "max", "min", "prod", "any", "all",
              "nansum", "norm", "linalg_vector_norm", "std", "var"}
CUMULATIVE = {"cumsum", "cumprod", "cummax", "cummin", "logcumsumexp"}
SORTS = {"sort", "argsort", "topk"}
# views that the schema does not mark as views
VIEWS = {"_unsafe_view", "_reshape_alias", "lift_fresh"}
CONTRACTIONS = {"einsum", "mm", "bmm", "addmm", "baddbmm", "mv", "dot",
                "convolution"}


def _nelems(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    # FLOPs by op name (``einsum`` for a whole einsum): what the totals
    # are made of
    by_op: dict = dataclasses.field(default_factory=dict)

    def __add__(self, o):
        ops = dict(self.by_op)
        for k, v in o.by_op.items():
            ops[k] = ops.get(k, 0.0) + v
        return Cost(self.flops + o.flops, self.bytes + o.bytes, ops)

    def __mul__(self, k):
        return Cost(self.flops * k, self.bytes * k,
                    {n: v * k for n, v in self.by_op.items()})

    def contraction_flops(self) -> float:
        """FLOPs of the contractions: the reference's ``dot_general`` (and
        ``conv_general_dilated``) share."""
        return sum(v for n, v in self.by_op.items() if n in CONTRACTIONS)


def _aliases(func) -> bool:
    """Whether ``func``'s result aliases an operand (a view, an in-place or
    an ``out=`` op): it allocates nothing."""
    return any(r.alias_info is not None for r in func._schema.returns)


def _reduced_rows(name, args, kwargs, x):
    """Rows of a row-wise composite: input elements over the reduced
    dims' size."""
    dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
    if name == "_softmax_backward_data":
        dims = args[2]
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return 1
    dims = [dims] if isinstance(dims, int) else list(dims)
    size = math.prod(x.shape[d] for d in dims) if x.dim() else 1
    return _nelems(x) // max(size, 1)


def op_flops(func, args, kwargs, out) -> float:
    """FLOPs of one aten op under the module's conventions."""
    name = func.overloadpacket.__name__.rstrip("_") or func.overloadpacket.__name__
    ins = [t for t in _tensors(args)]
    x = ins[0] if ins else None
    out_elems = sum(_nelems(t) for t in _tensors(out))
    if name in ("mm", "addmm"):
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1] + (
            out_elems if name == "addmm" else 0)
    if name in ("bmm", "baddbmm"):
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2] + (
            out_elems if name == "baddbmm" else 0)
    if name in ("mv", "dot"):
        return 2.0 * _nelems(args[0])
    if name == "convolution":
        w = args[1]
        return 2.0 * out_elems * _nelems(w) / max(w.shape[0], 1)
    if name in ZERO_FLOP or hlo_analysis.collective_kind(name):
        return 0.0
    if name in ROW_REDUCTIONS:
        per_elem, per_row = ROW_REDUCTIONS[name]
        src = args[1] if name == "_softmax_backward_data" else x
        return float(per_elem * _nelems(src)
                     + per_row * _reduced_rows(name, args, kwargs, src))
    if name in REDUCTIONS:
        return float(_nelems(x))
    if name in CUMULATIVE:
        return float(_nelems(x))
    if name in SORTS:
        n = _nelems(x)
        return float(n) * max(math.log2(max(n, 2)), 1.0)
    if name == "pow":
        exp = args[1] if len(args) > 1 else kwargs.get("exponent")
        integer = isinstance(exp, int) or (isinstance(exp, float)
                                           and exp.is_integer())
        return float(out_elems) * (1 if integer else 4)
    if name in PER_ELEM:
        # a backward op's first operand is the incoming gradient; the
        # log-sigmoid's result is a pair
        one = name.endswith("_backward") or name == "log_sigmoid_forward"
        return float(PER_ELEM[name] * (_nelems(x) if one else out_elems))
    if name in TRANSCENDENTAL:
        return 4.0 * out_elems
    return float(out_elems)


def einsum_flops(equation: str, operands) -> float | None:
    """FLOPs of ``torch.einsum(equation, *operands)`` as the reference's
    ``jnp.einsum`` lowers it (module docstring); None for a form this does
    not model (an ellipsis, a repeated label, three or more operands)."""
    eq = equation.replace(" ", "")
    if "..." in eq or "->" not in eq:
        return None
    lhs, result = eq.split("->")
    names = lhs.split(",")
    if len(names) != len(operands) or len(names) > 2 \
            or any(len(set(n)) != len(n) for n in names):
        return None
    size = {}
    for n, t in zip(names, operands):
        for c, d in zip(n, t.shape):
            size[c] = max(size.get(c, 1), d)
    flops = 0.0
    kept = []
    for i, n in enumerate(names):
        others = "".join(m for j, m in enumerate(names) if j != i)
        uniques = [c for c in n if c not in result and c not in others]
        if uniques:
            flops += _nelems(operands[i])          # reduce_sum first
        kept.append("".join(c for c in n if c not in uniques))
    if len(kept) == 2:
        flops += 2.0 * math.prod(size[c] for c in set(kept[0]) | set(kept[1]))
    return flops


class CostMode(TorchDispatchMode):
    """Counts every op it sees (module docstring): ``cost`` (a
    :class:`Cost` at global shapes), ``collectives`` (the records of
    ``hlo_analysis.collective_record``, local bytes) and ``peak_bytes``
    (the eager peak of live bytes a device allocated during the call)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.collectives = []
        self.live = 0
        self.peak_bytes = 0
        self._in_dtensor = False     # inside DTensor's dispatch of an op
        self._in_einsum = 0          # inside an einsum counted whole
        self._scale = 1              # ranks that split a local region's work
        self._storages = {}

    # ------------------------------------------------------ counting ----

    def _add(self, name, flops, nbytes, tensors):
        # the scale of a local region applies to its plain ops only; an op
        # on DTensors (a recompute that runs inside a local node's
        # backward) is at global shapes already
        s = 1 if any(isinstance(t, DTensor) for t in tensors) \
            else self._scale
        self.cost.flops += flops * s
        self.cost.bytes += nbytes * s
        if flops:
            self.cost.by_op[name] = self.cost.by_op.get(name, 0.0) + flops * s

    def _count(self, func, args, kwargs, out):
        if self._in_einsum:
            return
        name = func.overloadpacket.__name__
        if func.is_view or name in VIEWS \
                or func.namespace == "_c10d_functional":
            return                   # no FLOPs, no bytes (module docstring)
        flops = op_flops(func, args, kwargs, out)
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        nbytes = (sum(_nbytes(t) for t in ins)
                  + sum(_nbytes(t) for t in _tensors(out)))
        self._add(name.rstrip("_") or name, flops, nbytes, ins)

    def count_einsum(self, flops, operands, out):
        self._add("einsum", flops,
                  sum(_nbytes(t) for t in operands) + _nbytes(out), operands)

    def _track(self, func, out):
        """Live bytes of the fresh tensors ``func`` made: each DTensor's
        local shard, each plain tensor; storage shared by views once."""
        if _aliases(func):
            return
        for t in _tensors(out):
            local = t._local_tensor if isinstance(t, DTensor) else t
            key = local.untyped_storage()._cdata
            if key in self._storages:
                continue
            nbytes = _nbytes(local)
            self._storages[key] = nbytes
            self.live += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(t, self._free, key)

    def _free(self, key):
        self.live -= self._storages.pop(key, 0)

    def _record(self, func, args, out):
        rec = hlo_analysis.collective_record(func, args, out)
        if rec is not None:
            self.collectives.append(rec)

    # ------------------------------------------------------ dispatch ----

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor = any(issubclass(t, DTensor) for t in types)
        if self._in_dtensor:
            # a local op of DTensor's own dispatch: counted at the global
            # op already; only its collectives are recorded
            if dtensor:
                return NotImplemented
            out = func(*args, **kwargs)
            self._record(func, args, out)
            return out
        if dtensor:
            self._in_dtensor = True
            try:
                with self:
                    out = func(*args, **kwargs)
            finally:
                self._in_dtensor = False
        else:
            out = func(*args, **kwargs)
            self._record(func, args, out)
        self._count(func, args, kwargs, out)
        self._track(func, out)
        return out

    # ------------------------------------------------ local regions ----

    def local_call(self, fn, tensors, split):
        """``on_local_shards``'s call of ``fn``: its ops, and their
        backward ops, counted ``split`` times."""
        prev, self._scale = self._scale, split
        try:
            out = fn(*tensors)
        finally:
            self._scale = prev
        if split > 1:
            self._scale_backward(out, tensors, split)
        return out

    def _scale_backward(self, out, tensors, split):
        """Each autograd node that ``fn`` made runs its backward ops with
        the scale set: the nodes between the outputs and the inputs, told
        apart by their sequence numbers (later than every input's)."""
        inputs = [t.grad_fn._sequence_nr() for t in tensors
                  if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        after = max(inputs, default=-1)
        todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
        seen = set()
        while todo:
            node = todo.pop()
            if node is None or node in seen or node._sequence_nr() <= after:
                continue
            seen.add(node)
            if type(node).__name__ == "AccumulateGrad":
                continue
            node.register_prehook(self._enter(split))
            node.register_hook(self._leave)
            todo.extend(n for n, _ in node.next_functions)

    def _enter(self, split):
        def hook(grad_outputs):
            self._scale = split
        return hook

    def _leave(self, grad_inputs, grad_outputs):
        self._scale = 1


class _EinsumMode(TorchFunctionMode):
    """Counts each ``torch.einsum`` whole (module docstring) and keeps the
    aten ops it lowers to from being counted again."""

    def __init__(self, counter: CostMode):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.einsum or self.counter._in_einsum:
            return func(*args, **kwargs)
        eq, *ops = args
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = list(ops[0])
        flops = einsum_flops(eq, ops)
        if flops is None:
            return func(*args, **kwargs)
        self.counter._in_einsum += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self.counter._in_einsum -= 1
        self.counter.count_einsum(flops, ops, out)
        return out


@contextlib.contextmanager
def counting():
    """A :class:`CostMode` over the block, with einsums counted whole and
    ``on_local_shards`` regions scaled; yields the mode."""
    mode = CostMode()
    token = L.LOCAL_CALL.set(mode.local_call)
    try:
        with _EinsumMode(mode), mode:
            yield mode
    finally:
        L.LOCAL_CALL.reset(token)


def cost_of(fn, *args) -> Cost:
    """Run fn(*args) under the counter and return its total Cost (global
    shapes)."""
    with counting() as mode:
        fn(*args)
    return mode.cost
