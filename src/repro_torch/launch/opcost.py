"""Per-chip cost of a call, counted from the aten ops it dispatches: the
port's counterpart of ``repro.launch.hlocost``.

The reference parses the post-SPMD HLO of one chip's program.  The port
has no HLO, so :func:`op_cost` runs the call under a dispatch mode that
sees every aten op on the tensors one rank actually holds, below DTensor
dispatch (a DTensor op is let through to DTensor, which redistributes its
inputs and runs the local op, and that local op is the one counted), and
on meta tensors it allocates nothing.  It returns
``hlo_cost``'s keys, all per chip:

    flops              matmul-family ops only (mm, addmm, bmm, baddbmm,
                       mv, dot), 2*M*N*K, as ``_dot_flops`` counts dots
    bytes              operands + results of each op; views move nothing;
                       an in-place write into a slice or an indexed write
                       counts the written bytes, not the whole buffer
    collectives        result bytes of the ``c10d_functional`` ops that
                       DTensor issues, by the reference's five kinds
    collective_total   their sum
    collective_count   how many

Where the counts differ from the reference's by construction:

* Eager ops have no fusions, so ``bytes`` counts every intermediate that
  XLA would keep on chip inside a fusion (elementwise chains, softmax
  pieces): an upper bound of the HBM traffic, several times the fused
  count.
* A Python loop is counted once per iteration as it runs (the reference
  multiplies a ``while`` body by its trip count): the same totals.
* The sharding is DTensor's op by op, not GSPMD's whole-program choice, so
  the collectives, and the flops of a product DTensor chooses to compute
  on replicated operands, may differ.
* The calls DTensor makes on global-shaped stand-ins to infer an op's
  output (its sharding propagation) are not the program's and are not
  counted.
"""
from __future__ import annotations

import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# c10d_functional op name -> the reference's collective kind
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                   "all_gather_into_tensor_coalesced": "all-gather",
                   "all_reduce": "all-reduce",
                   "all_reduce_coalesced": "all-reduce",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "reduce_scatter_tensor_coalesced": "reduce-scatter",
                   "all_to_all_single": "all-to-all",
                   "broadcast": "collective-permute",
                   "permute_tensor": "collective-permute"}
# frames of DTensor's own bookkeeping, whose ops are not the program's: its
# sharding propagation (ops on global-shaped stand-ins) and the shard sizes
# its planner computes with small tensors
_PROPAGATION = ("_propagate_tensor_meta", "gen_fake_args", "gen_fake_kwargs",
                "local_shard_size_and_offset", "get_logical_shape",
                "redistribute_cost", "_gen_transform_infos",
                "compute_local_shape_and_global_offset")
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor"}


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def _matmul_flops(name, args, out) -> float:
    """2*M*N*K of a matmul-family op from its operands' and result's
    shapes."""
    if name in ("mm", "bmm"):
        a = args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if name in ("addmm", "baddbmm"):
        a = args[1]
        return 2.0 * out.numel() * a.shape[-1]
    if name == "mv":
        return 2.0 * args[0].numel()
    if name in ("dot", "vdot"):
        return 2.0 * args[0].numel()
    return 0.0


_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot", "vdot"}


def _in_propagation() -> bool:
    f = sys._getframe(2)
    for _ in range(40):
        if f is None:
            return False
        if f.f_code.co_name.startswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class OpCounter(TorchDispatchMode):
    """Counts flops, bytes and collectives of the aten ops dispatched
    inside it, on local (per-rank) tensors.  ``cost()`` gives the totals
    in ``hlo_cost``'s keys."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.collective_count = 0.0
        self.ops = 0  # aten ops counted

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor redistribute and run the local op, which comes
            # back through this mode on the local tensors
            return NotImplemented
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload) or _in_propagation():
            return out
        self.ops += 1
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional" or ns == "c10d_functional":
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                b = _nbytes(out)
                self.collectives[kind] += b
                self.collective_count += 1
                self.bytes += b + _nbytes(list(_tensors(args)))
            return
        if ns == "prim" or name in _FREE:
            return
        if func.is_view:
            return  # aliasing: no traffic
        if name in _MATMULS:
            self.flops += _matmul_flops(name, args, out)
        if name in ("index_put_", "index_put", "_index_put_impl_"):
            # an indexed write: the values in and out, and the indices
            idx = _nbytes([t for t in _tensors(args[1:2])])
            self.bytes += 2 * _nbytes(args[2]) + idx
            return
        if name in ("copy_", "copy") and isinstance(args[0], torch.Tensor):
            # a write into a view: the written region, read and written
            self.bytes += 2 * _nbytes(args[0])
            return
        if name in ("scatter_", "scatter_add_", "index_copy_",
                    "index_add_", "scatter", "scatter_add"):
            src = args[3] if len(args) > 3 else kwargs.get("src")
            self.bytes += 2 * _nbytes(src) + _nbytes(args[2])
            return
        self.bytes += _nbytes(list(_tensors(args))) + _nbytes(
            list(_tensors(kwargs.values()))) + _nbytes(out)

    def cost(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": dict(self.collectives),
                "collective_total": sum(self.collectives.values()),
                "collective_count": self.collective_count}


def op_cost(fn, *args, **kw) -> dict:
    """Per-chip ``{"flops", "bytes", "collectives", "collective_total",
    "collective_count"}`` of ``fn(*args, **kw)`` (its forward and, if it
    calls one, its backward), counted on this rank's tensors."""
    counter = OpCounter()
    with counter:
        fn(*args, **kw)
    return counter.cost()
