"""Sharding rules for quantized parameter trees.

The JAX package's ``parallel/sharding.py`` over ``torch.distributed``.
Each leaf gets a placement chosen jointly for a QTensor's arrays, so that
the group-wise scales shard with their weight axis, and a rank holds only
its shard of the quantized bytes.  The modes per parameter:

* "col"   - output channels over the tensor axis (column parallel): the
            codes', scales', zero points' and svd_up's rows; svd_down is
            replicated;
* "row"   - input channels over the tensor axis (row parallel), unpacked
            storage only (a packed row spans the whole input, so a packed
            weight is replicated), the codes' columns or groups and
            svd_down's columns; a row-parallel bias is replicated;
* "fsdp"  - output channels over the fsdp axis (gathered on use);
* None    - replicated.

An axis that does not divide a dimension leaves it replicated (JAX's
``_spec_for``).  ``qtensor_shardings`` gives each array's ``Placement``
(the dimension split over which axis, or none), as JAX's specs do.
``shard_params`` gives this rank's local shards as ``Sharded`` leaves,
each with its placement beside it, so the model functions know what they
hold (``models.dit.dit_forward`` runs the tensor-parallel forward on such
a tree).

The DiT needs one layout step that JAX's GSPMD, which moves shards
implicitly, does not: a rank's column-parallel ``qkv`` rows must be whole
heads' q, k and v rows, and ``linear1``'s also its slice of the MLP rows
past the 3·C boundary; the input columns of ``linear2`` follow the same
heads and MLP slice.  ``DIT_TP_SEGMENTS`` names these layers' segments
along the split dimension: a rank takes its part of each segment (a
placement's ``segments``).  A placement is kept only where every segment
divides (in whole quantization groups along the input); else the leaf is
replicated.
"""

from __future__ import annotations

import dataclasses

import torch

from ..policy import check_param_name_in
from ..tensor import QTensor, layer_count
from ..train.matmul import TrainQTensor, grad_carrier

__all__ = ["Placement", "Sharded", "qtensor_shardings", "shard_params",
           "DIT_TP_RULES", "DIT_TP_SEGMENTS", "logical_axis_rules",
           "is_sharded", "assemble", "take", "shard_batch",
           "gather_batch", "gather_leaf", "unshard_params"]

_FIELDS = ("qdata", "scale", "zero_point", "svd_up", "svd_down")


@dataclasses.dataclass(frozen=True)
class Placement:
    """``dim`` split over ``axis`` (``size`` ranks), or replicated where
    ``dim`` is None.  ``segments``: sizes along ``dim`` of the layout's
    segments, each split in ``size`` parts (empty: the whole dimension is
    one segment)."""
    dim: int | None = None
    axis: str | None = None
    size: int = 1
    segments: tuple = ()

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    def shifted(self) -> "Placement":
        """The placement of a stacked leaf (a leading layer axis)."""
        if self.dim is None:
            return self
        return dataclasses.replace(self, dim=self.dim + 1)


REPLICATED = Placement()


@dataclasses.dataclass
class Sharded:
    """A leaf as one rank holds it: ``local`` (a tensor, QTensor or
    TrainQTensor), ``placement`` (a Placement, or for a QTensor a QTensor
    of Placements) and the ``mesh``; the rule's ``mode`` and layout
    ``segments`` (whether or not the axis divides them)."""
    local: object
    placement: object
    mesh: object
    mode: str | None = None   # the rule's mode
    segments: tuple = ()      # the rule's layout segments (layer units)


def _place(mesh, shape, dim, axis, segments=None, unit=1) -> Placement:
    """``_spec_for``: dim ``dim`` of ``shape`` over ``axis`` where the axis
    divides it (and each segment, in ``unit``s), else replicated."""
    if axis is None or dim is None or dim >= len(shape):
        return REPLICATED
    n = mesh.shape[axis]
    if shape[dim] % n or shape[dim] < n:
        return REPLICATED
    segs = ()
    if segments:
        if any(s % unit for s in segments) or \
                sum(segments) != shape[dim] * unit:
            return REPLICATED
        segs = tuple(s // unit for s in segments)
        if any(s % n for s in segs):
            return REPLICATED
        if len(segs) == 1:
            segs = ()
    return Placement(dim, axis, n, segs)


def qtensor_shardings(qt: QTensor, mesh, mode: str | None,
                      axis: str = "tensor", segments=None) -> QTensor:
    """A QTensor of Placements matching ``qt``'s arrays (one layer's
    shapes).  ``segments``: the layout's segment sizes along the split
    dimension, in rows ("col") or input columns ("row")."""
    meta = qt.meta

    def shape(name):
        a = getattr(qt, name)
        return None if a is None else tuple(a.shape)

    def pl(name, dim, ax, unit=1):
        s = shape(name)
        return None if s is None else _place(mesh, s, dim, ax, segments,
                                             unit)
    if mode in ("col", "fsdp"):
        ax = "fsdp" if mode == "fsdp" else axis
        qd, sc = pl("qdata", 0, ax), pl("scale", 0, ax)
        zp = None if qt.zero_point is None else sc
        up = pl("svd_up", 0, ax)
        down = None if qt.svd_down is None else REPLICATED
    elif mode == "row":
        if meta.is_packed:
            return qtensor_shardings(qt, mesh, None, axis)
        # (O, C) or grouped (O, G, g): the C (or G) axis, in whole groups
        grouped = len(shape("qdata")) > 2
        unit = shape("qdata")[2] if grouped else 1
        qd = pl("qdata", 1, axis, unit)
        sc = pl("scale", 1, axis, unit)
        zp = None if qt.zero_point is None else sc
        up = None if qt.svd_up is None else REPLICATED
        down = pl("svd_down", 1, axis)
    else:
        qd = sc = REPLICATED
        zp = None if qt.zero_point is None else REPLICATED
        up = None if qt.svd_up is None else REPLICATED
        down = None if qt.svd_down is None else REPLICATED
    return QTensor(qdata=qd, scale=sc, zero_point=zp, svd_up=up,
                   svd_down=down, meta=meta)


def _array_placement(mesh, shape, mode, axis, segments=None) -> Placement:
    if mode in ("col", "fsdp") and len(shape) >= 1:
        return _place(mesh, shape, 0, "fsdp" if mode == "fsdp" else axis,
                      segments)
    if mode == "row" and len(shape) >= 2:
        return _place(mesh, shape, 1, axis, segments)
    return REPLICATED


# ---------------------------------------------------------------------------
# Cutting and joining shards
# ---------------------------------------------------------------------------

def take(a: torch.Tensor, pl: Placement, rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``a`` (its part of each segment); ``a``
    itself where replicated."""
    if pl is None or not pl.sharded or pl.size == 1:
        return a
    n, dim = pl.size, pl.dim
    segs = pl.segments or (a.shape[dim],)
    parts, start = [], 0
    for s in segs:
        parts.append(a.narrow(dim, start + rank * (s // n), s // n))
        start += s
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
    return out.contiguous()


def assemble(shards, pl: Placement) -> torch.Tensor:
    """The whole array from every rank's shard, in rank order (the inverse
    of ``take``)."""
    if pl is None or not pl.sharded:
        return shards[0]
    n, dim = pl.size, pl.dim
    local = shards[0].shape[dim]
    segs = pl.segments or (local * n,)
    pieces, start = [], 0
    for s in segs:
        k = s // n
        pieces += [sh.narrow(dim, start, k) for sh in shards]
        start += k
    return torch.cat(pieces, dim=dim)


def _local_meta(meta, qd_local, stacked: bool):
    """``meta`` for a shard: its codes' shape gives the quantized shape
    (unpacked), the split dimension the original shape."""
    one = tuple(qd_local.shape[1:] if stacked else qd_local.shape)
    orig = list(meta.original_shape)
    qshape = list(meta.quantized_shape)
    if meta.is_packed:
        orig[0] = qshape[0] = one[0]
    else:
        qshape = list(one)
        orig[0] = one[0]
        if len(one) > 2:
            orig[1] = one[1] * one[2]
        elif len(orig) > 1:
            orig[1] = one[1]
    return dataclasses.replace(meta, original_shape=tuple(orig),
                               quantized_shape=tuple(qshape))


def _take_qt(qt: QTensor, pls: QTensor, rank: int, stacked: bool):
    arrays = {f: None if getattr(qt, f) is None
              else take(getattr(qt, f), getattr(pls, f), rank)
              for f in _FIELDS}
    if all(getattr(pls, f) is None or not getattr(pls, f).sharded
           for f in _FIELDS):
        return qt
    return QTensor(meta=_local_meta(qt.meta, arrays["qdata"], stacked),
                   **arrays)


def _shift_qt(pls: QTensor) -> QTensor:
    return QTensor(meta=pls.meta, **{
        f: None if getattr(pls, f) is None else getattr(pls, f).shifted()
        for f in _FIELDS})


# ---------------------------------------------------------------------------
# shard_params
# ---------------------------------------------------------------------------

# Default tensor-parallel rules for the Flux-style DiT (column-shard the
# fan-out projections, row-shard the fan-in projections).
DIT_TP_RULES = {
    "qkv": "col",
    "fc1": "col",
    "linear1": "col",
    "proj": "row",
    "fc2": "row",
    "linear2": "row",
    "img_mod": "col",
    "txt_mod": "col",
}

# The DiT's layout segments along the split dimension, from one layer's
# (out, in): qkv's q | k | v rows, linear1's q | k | v | MLP rows, and
# linear2's attention | MLP input columns.
DIT_TP_SEGMENTS = {
    "qkv": lambda o, k: (o // 3,) * 3,
    "linear1": lambda o, k: (k, k, k, o - 3 * k),
    "linear2": lambda o, k: (o, k - o),
}


def logical_axis_rules(tp_rules: dict[str, str] | None = None):
    return dict(DIT_TP_RULES if tp_rules is None else tp_rules)


def is_sharded(tree) -> bool:
    """Whether ``tree`` holds ``Sharded`` leaves (the first leaf tells)."""
    while isinstance(tree, (dict, list, tuple)) and tree:
        tree = (next(iter(tree.values())) if isinstance(tree, dict)
                else tree[0])
    return isinstance(tree, Sharded)


def _is_stacked(path, prefixes) -> bool:
    for pfx in prefixes:
        if not path.startswith(pfx + "."):
            continue
        head = path[len(pfx) + 1:].split(".")[0]
        # numeric: a list entry; "first": stack_dit_blocks' odd block 0
        if not head.isdigit() and head != "first":
            return True
    return False


def _weight_dims(w):
    """(out, in) of one layer's weight, or None."""
    if isinstance(w, TrainQTensor):
        w = w.qt
    if isinstance(w, QTensor):
        s = w.meta.original_shape
    elif isinstance(w, torch.Tensor):
        s = tuple(w.shape)
    else:
        return None
    return (s[0], s[1]) if len(s) == 2 else None


def shard_params(params, mesh, rules: dict[str, str | None],
                 default: str | None = None, axis: str = "tensor",
                 stacked_prefixes: tuple = ("transformer_blocks.rest",
                                            "single_transformer_blocks.rest",
                                            "transformer_blocks",
                                            "single_transformer_blocks"),
                 segments: dict | None = None):
    """This rank's shards of ``params`` as ``Sharded`` leaves.

    ``rules`` maps name patterns (``policy.check_param_name_in``) to a mode
    in {"col", "row", "fsdp", None}; a bias follows its layer for "col" /
    "fsdp" and is replicated for "row".  ``segments`` maps patterns to a
    layer's layout segments (``DIT_TP_SEGMENTS`` by default).  Stacked
    block leaves (``stack_dit_blocks``: a path under a ``stacked_prefixes``
    entry not followed by an index) are placed by one layer's shapes and
    keep their layer axis whole.  A TrainQTensor's shard gets a gradient
    carrier of its own; a floating leaf that requires grad comes back as a
    new leaf with storage of its own."""
    segments = DIT_TP_SEGMENTS if segments is None else segments

    def rank_of(pl_axis):
        return mesh.get_local_rank(pl_axis) if pl_axis else 0

    def leaf(path, x, mode, segs):
        stacked = _is_stacked(path, stacked_prefixes)
        if isinstance(x, (QTensor, TrainQTensor)):
            qt = x.qt if isinstance(x, TrainQTensor) else x
            if stacked and layer_count(qt) is None:
                stacked = False
            one = qt
            if stacked:
                one = QTensor(meta=qt.meta, **{
                    f: None if getattr(qt, f) is None
                    else getattr(qt, f)[0] for f in _FIELDS})
            pls = qtensor_shardings(one, mesh, mode, axis, segs)
            if stacked:
                pls = _shift_qt(pls)
            ax = pls.qdata.axis or pls.scale.axis
            local = _take_qt(qt, pls, rank_of(ax), stacked)
            if isinstance(x, TrainQTensor):
                local = TrainQTensor(qt=local, delta=grad_carrier(
                    local.meta.original_shape if not stacked
                    else (local.qdata.shape[0],)
                    + tuple(local.meta.original_shape),
                    local.qdata.device))
            return Sharded(local, pls, mesh, mode, tuple(segs or ()))
        if isinstance(x, torch.Tensor):
            m = None if (path.endswith("bias") and mode == "row") else mode
            shape = tuple(x.shape[1:] if stacked else x.shape)
            pl = _array_placement(mesh, shape, m, axis, segs)
            if stacked:
                pl = pl.shifted()
            local = take(x, pl, rank_of(pl.axis))
            if x.requires_grad:   # a leaf of its own (the update writes it)
                local = local.detach().clone().requires_grad_()
            return Sharded(local, pl, mesh, m, tuple(segs or ()))
        return x

    def walk(tree, path):
        if isinstance(tree, dict):
            out = {}
            w = tree.get("weight")
            dims = None
            if w is not None:
                one = w
                if _is_stacked(path + "weight", stacked_prefixes):
                    one = _first_layer(w)
                dims = _weight_dims(one)
            for k in tree:
                p = f"{path}{k}"
                if isinstance(tree[k], (dict, list, tuple)):
                    out[k] = walk(tree[k], p + ".")
                    continue
                match = check_param_name_in(p, list(rules))
                mode = rules[match] if match is not None else default
                segs = None
                if dims is not None and k in ("weight", "bias"):
                    smatch = check_param_name_in(p, list(segments))
                    if smatch is not None:
                        segs = segments[smatch](*dims)
                out[k] = leaf(p, tree[k], mode, segs)
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}{i}.")
                              for i, v in enumerate(tree))
        return leaf(path[:-1], tree, default, None)

    return walk(params, "")


def _first_layer(w):
    """Layer 0 of a stacked weight (for its per-layer dims)."""
    if isinstance(w, TrainQTensor):
        w = w.qt
    if isinstance(w, QTensor):
        if layer_count(w) is None:
            return w
        from ..tensor import layer_view
        return layer_view(w, 0)
    return w[0] if isinstance(w, torch.Tensor) and w.dim() > 2 else w


def gather_leaf(s: Sharded):
    """The whole leaf from its ``Sharded`` shards (an all-gather along its
    axis, no gradient; every rank of the axis calls it): a tensor, or a
    QTensor (a TrainQTensor's codes) under the whole leaf's meta."""
    pl, x = s.placement, s.local
    if isinstance(pl, QTensor):
        qt = x.qt if isinstance(x, TrainQTensor) else x
        ax = pl.qdata.axis or pl.scale.axis
        if ax is None:
            return qt
        comm = s.mesh.comm(ax)
        arrays = {}
        for f in _FIELDS:
            a, fp = getattr(qt, f), getattr(pl, f)
            arrays[f] = None if a is None else (
                assemble(comm._gather_list(a), fp) if fp.sharded
                and comm.size > 1 else a)
        return QTensor(meta=pl.meta, **arrays)
    x = x.detach()
    if not pl.sharded or pl.size == 1:
        return x
    return assemble(s.mesh.comm(pl.axis)._gather_list(x), pl)


def unshard_params(tree):
    """The whole tree from this rank's ``shard_params`` tree (every rank
    calls it: each sharded leaf is all-gathered)."""
    if isinstance(tree, dict):
        return {k: unshard_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unshard_params(v) for v in tree)
    return gather_leaf(tree) if isinstance(tree, Sharded) else tree


# ---------------------------------------------------------------------------
# The batch on the data axis
# ---------------------------------------------------------------------------

def shard_batch(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of a global batch (JAX's ``device_put`` with
    ``P("data")``): the leading axis split over ``axis``."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide over "
                         f"{axis}={n}")
    return take(x, Placement(0, axis, n), mesh.get_local_rank(axis))


def gather_batch(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The global batch from every rank's rows (no gradient)."""
    return mesh.comm(axis).gather(x.detach(), 0)
