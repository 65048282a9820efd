"""Cost model of a step for the dry-run roofline: the counterpart of the
jaxpr half of ``src/repro/launch/hlo_cost.py`` (``jaxpr_cost`` :117,
``step_cost`` :149).

:func:`step_cost` runs a step, typically on ``meta`` tensors (shapes only,
nothing allocated or computed), under :class:`CostCounter`, a
``TorchDispatchMode`` that charges every aten op the step runs by the
reference's rules:

- a matmul-family op (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  ``dot``, …) or a convolution: exactly 2·B·M·N·K (a convolution 2 · its
  output's elements · the kernel's spatial size · its input channels per
  group; ``convolution_backward`` one such count a gradient it returns);
- a reduction (:data:`REDUCTIONS`): its input's element count;
- every other op: its output's element count;
- bytes, read plus written, only for the "major" ops (:data:`MAJOR_OPS`:
  the reference's ``_MAJOR_MEM_PRIMS`` mapped to aten below); chains of
  elementwise ops are taken as fused, as the reference takes them.

The reference's jaxpr prims map to these aten ops:

- ``dot_general`` → ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``addbmm``,
  ``mv``, ``addmv``, ``dot``, ``vdot``;
- ``conv_general_dilated`` → ``convolution``, ``convolution_backward``;
- ``gather`` → ``index`` (tensor indices), ``index_select``, ``gather``,
  ``embedding``, ``take``;
- ``scatter`` / ``scatter-add`` → ``index_put(_)``, ``_index_put_impl_``,
  ``index_add(_)``, ``index_copy(_)``, ``scatter(_)``, ``scatter_add(_)``,
  ``scatter_reduce(_)``, ``embedding_dense_backward``;
- ``dynamic_slice`` / ``dynamic_update_slice`` → ``copy_`` (a write into
  a view: the KV and SSM cache writes), ``slice_scatter``,
  ``select_scatter``; a read at a Python-int offset is a view here and
  moves nothing by itself;
- ``reduce_*``, ``argmax``, ``argmin`` → :data:`REDUCTIONS`;
- ``sort``, ``top_k`` → ``sort``, ``topk``;
- ``random_bits`` → the random draws (``normal(_)``, ``randn``,
  ``uniform_``, ``bernoulli(_)``, ``randint``, ``random_``, …);
- ``cumsum``, ``cumlogsumexp``, ``cummax`` → ``cumsum``, ``cumprod``,
  ``logcumsumexp``, ``cummax``, ``cummin``.

Ops that do no arithmetic are charged nothing: views (an output that
aliases an input without writing it: ``view``, ``transpose``, ``select``,
``slice``, ``expand``, …) and allocations (``empty`` and its kin). The
reference's jaxpr charges its ``reshape`` and ``transpose`` prims their
output elements; aten ops are coarser (``_softmax`` is one op, five prims
there) or finer (a backward's ``select_backward`` materializes a zero
tensor the scan's cotangent never does) than jaxpr prims, so ``flops``
and ``bytes`` are this port's own model of its own ops. ``matmul_flops``,
the matmul and convolution part alone, is what the tests hold exactly
against the reference's dot and conv count.

Python loops (the layer stack, microbatches, DP chunks, KV chunks) and
backward passes are counted by running them: nothing runs once for many,
so there is no trip-count correction. Under the counter (a dispatch mode)
a kernel wrapper calls its ``torch.library`` custom op
(``kernels._build.through_op``). The counter charges such a call its
body run on meta copies of the arguments, which is the plain version of
``kernels/ref.py``, and then runs the op itself uncounted: on meta its
fake (the kernel's output layout), on a CUDA tensor the launch. So a step
with ``use_pallas`` counts the products of its twin without it, and a
step counts the same on the card as on meta. A launch outside a custom op
(the mix kernels, and the client routes a vmap rule calls) is not seen
on a CUDA tensor; on meta every wrapper runs its plain version, which is
counted.

The collective parser (``collective_wire_bytes`` :222) waits for ROADMAP
Queue 1 item 14b (the mesh dry-run).
"""
from __future__ import annotations

import math
import weakref
from collections import Counter
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import _build

MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
           "vdot"}
CONVOLUTIONS = {"convolution", "convolution_backward"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any",
              "all", "argmax", "argmin", "cumsum", "cumprod", "logsumexp",
              "logcumsumexp", "cummax", "cummin", "norm",
              "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
              "nansum", "count_nonzero"}
MAJOR_OPS = (MATMULS | CONVOLUTIONS | REDUCTIONS | {
    # gather
    "index", "index_select", "gather", "embedding", "take",
    # scatter, scatter-add
    "index_put", "index_put_", "_index_put_impl_", "index_add",
    "index_add_", "index_copy", "index_copy_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "embedding_dense_backward",
    # dynamic (update) slices
    "copy_", "slice_scatter", "select_scatter",
    # sort, top-k
    "sort", "topk",
    # random draws
    "normal", "normal_", "randn", "randn_like", "rand", "rand_like",
    "uniform_", "bernoulli", "bernoulli_", "randint", "randint_like",
    "random_", "exponential_", "multinomial", "randperm"})
ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


def _leaves(x, out: list) -> list:
    """The leaves of an op's arguments or outputs (nested tuples, lists
    and dicts), in order; cheaper than a general pytree walk, which a
    dispatch mode would pay on every op."""
    if isinstance(x, (tuple, list)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _leaves(y, out)
    else:
        out.append(x)
    return out


def _map(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, y) for y in x)
    return fn(x)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for t in _leaves(tree, []) if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _prod(shape) -> int:
    return math.prod(int(d) for d in shape)


def _matmul_flops(name: str, args) -> float:
    """2·B·M·N·K of a matmul-family op from its operands' shapes."""
    if name in ("addmm", "addbmm", "baddbmm", "addmv"):
        args = args[1:]
    a, b = args[0], args[1]
    if name in ("dot", "vdot"):
        return 2.0 * a.shape[0]
    if name in ("mv", "addmv"):
        return 2.0 * a.shape[0] * a.shape[1]
    if name == "mm":
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    # bmm, baddbmm, addbmm: [B, M, K] x [B, K, N]
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv_flops(name: str, args, out) -> float:
    """The reference's ``_conv_flops``: 2 · output elements · kernel
    spatial size · input channels per group (a transposed convolution the
    same from its input's side); ``convolution_backward`` one such count
    for each of the input and weight gradients it returns."""
    if name == "convolution":
        x, w, transposed = args[0], args[1], args[6]
        spatial = _prod(w.shape[2:])
        if transposed:
            return 2.0 * x.numel() * w.shape[1] * spatial
        return 2.0 * out.numel() * w.shape[1] * spatial
    grad_out, x, w = args[0], args[1], args[2]
    transposed, mask = args[7], args[10]
    spatial = _prod(w.shape[2:])
    one = 2.0 * (x.numel() if transposed else grad_out.numel()) \
        * w.shape[1] * spatial
    return one * (int(mask[0]) + int(mask[1]))


def _is_view(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


def _meta(x):
    if isinstance(x, torch.Tensor) and x.device.type != "meta":
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    return x


class _Layout:
    """The shape, strides and dtype of a memoized meta output."""

    __slots__ = ("shape", "stride", "dtype")

    def __init__(self, t: torch.Tensor):
        self.shape, self.stride, self.dtype = (tuple(t.shape), t.stride(),
                                               t.dtype)


def _layout(x):
    return _Layout(x) if isinstance(x, torch.Tensor) else x


def _fresh(x):
    if isinstance(x, _Layout):
        return torch.empty_strided(x.shape, x.stride, dtype=x.dtype,
                                   device="meta")
    return x


def _writes(func) -> bool:
    return any(r.alias_info is not None and r.alias_info.is_write
               for r in func._schema.returns)


class CostCounter(TorchDispatchMode):
    """Counts the ops run under it (module docstring): ``flops``,
    ``bytes`` and ``matmul_flops`` (floats) and ``by_op`` (flops by aten
    op name). With ``memory`` it also
    follows the bytes of the tensors the ops create while they live:
    ``peak_bytes`` is the most alive at once (on meta, what the step would
    hold on the device beside its arguments; views and in-place results
    create nothing), and ``created`` counts the tensors created by (op,
    shape, dtype)."""

    def __init__(self, memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.matmul_flops = 0.0
        self.by_op: Counter = Counter()
        self.memory = memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self.created: Counter = Counter()
        self._kinds: Dict = {}
        self._memo: Dict = {}
        self._live: Dict = {}    # weak references to the live tensors

    def _created(self, name: str, outs) -> None:
        for t in outs:
            n = _bytes(t)
            self.created[name, tuple(t.shape), t.dtype] += 1
            self.live_bytes += n

            def freed(ref, n=n):
                del self._live[id(ref)]
                self.live_bytes -= n
            ref = weakref.ref(t, freed)
            self._live[id(ref)] = ref
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _kind(self, func):
        """(kind, aten name, major, creates) of ``func``, classified
        once: ``creates`` when its outputs are new tensors (not views of,
        or writes into, its inputs)."""
        kind = self._kinds.get(func)
        if kind is None:
            name = func.overloadpacket.__name__
            if func.namespace == "repro_torch":
                k = "kernel"
            elif torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd"):
                k = "composite"
            elif name in MATMULS:
                k = "matmul"
            elif name in CONVOLUTIONS:
                k = "conv"
            elif name in ALLOCATIONS or _is_view(func):
                k = "free"
            elif name in REDUCTIONS and func._overloadname != "other":
                k = "reduce"   # (max.other and min.other are elementwise)
            else:
                k = "other"
            creates = k not in ("kernel", "composite") \
                and not _is_view(func) \
                and not _writes(func)
            kind = self._kinds[func] = (k, name, name in MAJOR_OPS, creates)
        return kind

    def _run(self, func, args, kwargs, flat, creates: bool):
        """``func`` on its arguments. An op that creates meta outputs from
        meta tensors alone (or from no tensor) is run once for each
        signature (shapes, strides, dtypes and the other arguments): later
        calls get fresh empty outputs of the same layout, without the op's
        meta function (most are Python, and a step runs the same layer's
        ops again and again)."""
        if not creates:
            return func(*args, **kwargs)
        key = [func]
        for a in flat:
            if isinstance(a, torch.Tensor):
                if a.device.type != "meta":
                    return func(*args, **kwargs)
                key.append((a.shape, a.stride(), a.dtype,
                            a.storage_offset()))
            elif isinstance(a, (list, dict, set)):
                key.append(repr(a))
            else:
                key.append(a)
        try:
            key = tuple(key)
            spec = self._memo.get(key)
        except TypeError:   # an argument that does not hash
            return func(*args, **kwargs)
        if spec is None:
            out = func(*args, **kwargs)
            # (a factory op on another device is not taken again)
            on_meta = all(t.device.type == "meta" for t in _tensors(out))
            self._memo[key] = _map(_layout, out) if on_meta else False
            return out
        if spec is False:
            return func(*args, **kwargs)
        return _map(_fresh, spec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind, name, major, creates = self._kind(func)
        if kind == "kernel":
            # a kernel's custom op: charged its body on meta copies (the
            # plain version), counted op by op; the op itself uncounted
            with self:
                _build.OP_BODIES[func.name()](
                    *_map(_meta, args),
                    **{k: _map(_meta, v) for k, v in kwargs.items()})
            out = func(*args, **kwargs)
            if self.memory:
                self._created(name, _tensors(out))
            return out
        if kind == "composite":
            # an op a call at the top level decomposes before any mode
            # sees it: seen here inside a kernel op's body, below autograd
            with self:
                return func.decompose(*args, **kwargs)
        flat = _leaves((args, kwargs), [])
        out = self._run(func, args, kwargs, flat, creates)
        outs = _tensors(out)
        if self.memory and creates:
            self._created(name, outs)
        if kind == "free":
            return out
        if kind == "matmul":
            f = _matmul_flops(name, args)
            self.matmul_flops += f
            if name.startswith("add"):
                f += sum(t.numel() for t in outs)
        elif kind == "conv":
            f = _conv_flops(name, args, out)
            self.matmul_flops += f
        elif kind == "reduce":
            ins = _tensors(args)
            f = float(ins[0].numel()) if ins else 0.0
        else:
            f = float(sum(t.numel() for t in outs))
        self.flops += f
        self.by_op[name] += f
        if major:
            self.bytes += sum(_bytes(t) for t in flat
                              if isinstance(t, torch.Tensor))
            self.bytes += sum(_bytes(t) for t in outs)
        return out


def step_cost(fn, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter` and return
    ``{"flops", "bytes", "matmul_flops"}`` of the whole call, Python loops
    and backward passes included (on meta inputs nothing is allocated)."""
    counter = CostCounter()
    with counter:
        fn(*args, **kwargs)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "matmul_flops": counter.matmul_flops}
