"""Shape and indexing ops (counterpart of ``mxnet_tpu/ops/matrix.py``): what
the ResNet graphs, the LSTM layer's graph, the bucketed LSTM LM
(``transpose``) and the transformer LM use."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ndarray.ndarray import torch_dtype
from .registry import param, register

__all__ = ["infer_reshape"]


def infer_reshape(src_shape, target, reverse=False):
    """MXNet's reshape target codes (``matrix.py:20-58``): 0 keeps a dim,
    -1 infers one, -2 copies the rest, -3 merges two, -4 splits one into
    the next two entries."""
    src = list(src_shape)
    if reverse:
        src = src[::-1]
        target = tuple(target)[::-1]
    out = []
    i = 0
    t = list(target)
    j = 0
    while j < len(t):
        d = t[j]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            d1, d2 = t[j + 1], t[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(d)
            if i < len(src):
                i += 1
        j += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(src_shape)) if src_shape else 1
        out[out.index(-1)] = total // known
    if reverse:
        out = out[::-1]
    return tuple(int(d) for d in out)


@register("Reshape", aliases=("reshape",),
          params={"shape": param("shape", ()), "reverse": param(bool, False),
                  "target_shape": param("shape", ()),
                  "keep_highest": param(bool, False)})
def _reshape(attrs, x):
    tgt = attrs["shape"] or attrs["target_shape"]
    return x.reshape(infer_reshape(tuple(x.shape), tgt, attrs["reverse"]))


@register("Flatten", aliases=("flatten",))
def _flatten(attrs, x):
    return x.reshape(x.shape[0], -1)


@register("Concat", aliases=("concat",),
          params={"dim": param(int, 1), "num_args": param(int, 0)})
def _concat(attrs, *xs):
    dim = attrs["dim"] % xs[0].dim()
    if xs[0].device.type == "meta":
        # shape inference: torch.cat's meta kernel imports torch._dynamo at
        # first use, which takes seconds
        shape = list(xs[0].shape)
        shape[dim] = sum(x.shape[dim] for x in xs)
        return xs[0].new_empty(shape)
    return torch.cat(xs, dim=dim)


@register("SwapAxis", aliases=("swapaxes",),
          params={"dim1": param(int, 0), "dim2": param(int, 0)})
def _swapaxes(attrs, x):
    return x.transpose(attrs["dim1"], attrs["dim2"])


@register("transpose", params={"axes": param("shape", ())})
def _transpose(attrs, x):
    """``x`` with its axes permuted to ``axes``, or reversed when ``axes``
    is empty (``matrix.py:75``)."""
    axes = attrs["axes"] or tuple(range(x.dim() - 1, -1, -1))
    return x.permute(*axes)


@register("expand_dims", params={"axis": param(int, 0, required=True)})
def _expand_dims(attrs, x):
    return x.unsqueeze(attrs["axis"])


def _embedding_hint(attrs, shapes):
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (attrs["input_dim"], attrs["output_dim"])
    return out


@register("Embedding", aliases=("embedding",), arg_names=("data", "weight"),
          shape_hint=_embedding_hint,
          params={"input_dim": param(int, 0, required=True),
                  "output_dim": param(int, 0, required=True),
                  "dtype": param("dtype", "float32"),
                  "sparse_grad": param(bool, False)})
def _embedding(attrs, data, weight):
    """Rows of ``weight`` for the ids in ``data`` (float ids truncated to
    integers), as the reference's ``jnp.take`` in its default mode
    (``matrix.py:308``): an id in ``[-input_dim, 0)`` wraps, any other id
    outside ``[0, input_dim)`` gives a row of NaN and sends no gradient to
    the table.  The gather index is clamped and the NaN put in with
    ``torch.where``, so a bad id costs no host sync and no device-side
    assert."""
    n = weight.shape[0]
    ids = data.long()
    valid = (ids >= -n) & (ids < n)
    idx = torch.where(ids < 0, ids + n, ids).clamp(0, max(n - 1, 0))
    rows = F.embedding(idx, weight)
    return torch.where(valid.unsqueeze(-1), rows,
                       torch.full((), float("nan"), dtype=rows.dtype,
                                  device=rows.device))


@register("zeros_like")
def _zeros_like(attrs, x):
    return torch.zeros_like(x)


@register("squeeze", params={"axis": param("shape", None)})
def _squeeze(attrs, x):
    ax = attrs["axis"]
    if not ax:
        return x.squeeze()
    return x.squeeze(tuple(a % x.dim() for a in ax))


def _positions(n, b, e, s):
    """The indices ``range(n)[b:e:s]`` (``None`` ends)."""
    return range(*slice(b, e, s).indices(n))


def _take_range(x, axis, idx: range):
    """``x`` at the positions ``idx`` along ``axis``: a view for a forward
    step, a gather otherwise (PyTorch slices take no negative step)."""
    if idx.step == 1:
        return x.narrow(axis, idx.start, max(len(idx), 0))
    return torch.index_select(x, axis, torch.tensor(list(idx),
                                                    dtype=torch.long,
                                                    device=x.device))


@register("slice", aliases=("crop",),
          params={"begin": param("shape", ()), "end": param("shape", ()),
                  "step": param("shape", ())})
def _slice(attrs, x):
    step = attrs["step"] or (None,) * len(attrs["begin"])
    for axis, (b, e, s) in enumerate(zip(attrs["begin"], attrs["end"],
                                         step)):
        x = _take_range(x, axis, _positions(x.shape[axis], b, e,
                                            None if s == 0 else s))
    return x


@register("slice_axis", params={"axis": param(int, 0, required=True),
                                "begin": param(int, 0, required=True),
                                "end": param("shape", None)})
def _slice_axis(attrs, x):
    ax = attrs["axis"] % x.dim()
    end = attrs["end"]
    end = int(end[0]) if end else None
    return _take_range(x, ax, _positions(x.shape[ax], attrs["begin"], end,
                                         None))


@register("slice_like", params={"axes": param("shape", ())})
def _slice_like(attrs, x, like):
    axes = attrs["axes"] or tuple(range(x.dim()))
    for a in axes:
        a = a % x.dim()
        x = x.narrow(a, 0, like.shape[a])
    return x


@register("dot", arg_names=("lhs", "rhs"),
          params={"transpose_a": param(bool, False),
                  "transpose_b": param(bool, False)})
def _dot(attrs, a, b):
    """The last axis of ``a`` against the first of ``b``
    (``matrix.py:144``); ``transpose_a`` moves ``a``'s first axis last,
    ``transpose_b`` ``b``'s last axis first."""
    if attrs["transpose_a"]:
        a = a.movedim(0, -1)
    if attrs["transpose_b"]:
        b = b.movedim(-1, 0)
    return torch.tensordot(a, b, dims=1)


@register("batch_dot", arg_names=("lhs", "rhs"),
          params={"transpose_a": param(bool, False),
                  "transpose_b": param(bool, False)})
def _batch_dot(attrs, a, b):
    if attrs["transpose_a"]:
        a = a.transpose(-1, -2)
    if attrs["transpose_b"]:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@register("stack", params={"axis": param(int, 0), "num_args": param(int, 0)})
def _stack(attrs, *xs):
    return torch.stack(xs, dim=attrs["axis"])


@register("SliceChannel", aliases=("split",),
          params={"num_outputs": param(int, 1, required=True),
                  "axis": param(int, 1), "squeeze_axis": param(bool, False)},
          nout=lambda attrs: attrs["num_outputs"])
def _split(attrs, x):
    ax = attrs["axis"] % x.dim()
    parts = torch.chunk(x, attrs["num_outputs"], dim=ax)
    if attrs["squeeze_axis"]:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("tile", params={"reps": param("shape", (), required=True)})
def _tile(attrs, x):
    return torch.tile(x, attrs["reps"])


@register("repeat", params={"repeats": param(int, 1, required=True),
                            "axis": param("shape", None)})
def _repeat(attrs, x):
    ax = attrs["axis"]
    if ax is None:
        return torch.repeat_interleave(x.reshape(-1), attrs["repeats"])
    return torch.repeat_interleave(x, attrs["repeats"], dim=int(ax[0]))


@register("Pad", aliases=("pad",),
          params={"mode": param(["constant", "edge", "reflect"], "constant"),
                  "pad_width": param("shape", (), required=True),
                  "constant_value": param(float, 0.0)})
def _pad(attrs, x):
    """``pad_width`` gives (before, after) per axis, first axis first; edge
    and reflect padding take the spatial axes only (N and C unpadded), as
    PyTorch's modes do."""
    pw = attrs["pad_width"]
    flat = []
    for i in reversed(range(len(pw) // 2)):
        flat += [pw[2 * i], pw[2 * i + 1]]
    if attrs["mode"] == "constant":
        return F.pad(x, flat, value=attrs["constant_value"])
    mode = "replicate" if attrs["mode"] == "edge" else "reflect"
    return F.pad(x, flat[:2 * (x.dim() - 2)], mode=mode)


@register("reverse", aliases=("flip",),
          params={"axis": param("shape", (), required=True)})
def _reverse(attrs, x):
    return torch.flip(x, dims=tuple(a % x.dim() for a in attrs["axis"]))


@register("depth_to_space", params={"block_size": param(int, 1,
                                                        required=True)})
def _depth_to_space(attrs, x):
    b = attrs["block_size"]
    n, c, h, w = x.shape
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth", params={"block_size": param(int, 1,
                                                        required=True)})
def _space_to_depth(attrs, x):
    b = attrs["block_size"]
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


@register("reorg", aliases=("newreorg", "Reorg", "NewReorg"),
          params={"stride": param(int, 2)})
def _reorg(attrs, x):
    """The fork's YOLO reorg (``matrix.py:270``): space to depth with
    stride s on NCHW, channels outermost."""
    s = attrs["stride"]
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // s, s, w // s, s).permute(0, 1, 3, 5, 2, 4)
    return y.reshape(n, c * s * s, h // s, w // s)


# --------------------------------------------------------------------------
# indexing
# --------------------------------------------------------------------------
def _int_index(t):
    return t.long()


@register("take", arg_names=("a", "indices"),
          params={"axis": param(int, 0),
                  "mode": param(["clip", "wrap", "raise"], "clip")})
def _take(attrs, a, indices):
    """``a`` at ``indices`` along ``axis``: out-of-range indices clipped
    (``clip``, and ``raise``, as the reference clips it) or wrapped."""
    axis = attrs["axis"] % a.dim()
    n = a.shape[axis]
    idx = _int_index(indices)
    idx = torch.remainder(idx, n) if attrs["mode"] == "wrap" \
        else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + tuple(indices.shape)
                       + a.shape[axis + 1:])


@register("batch_take", arg_names=("a", "indices"))
def _batch_take(attrs, a, indices):
    idx = _int_index(indices).reshape(-1, 1)
    idx = torch.where(idx < 0, idx + a.shape[1], idx)
    return torch.gather(a, 1, idx).reshape(indices.shape)


@register("one_hot", params={"depth": param(int, 0, required=True),
                             "on_value": param(float, 1.0),
                             "off_value": param(float, 0.0),
                             "dtype": param("dtype", "float32")})
def _one_hot(attrs, indices):
    """Rows of ``depth`` with ``on_value`` at each index (none for an index
    outside ``[0, depth)``) and ``off_value`` elsewhere."""
    dt = torch_dtype(attrs["dtype"] or "float32")
    hot = _int_index(indices).unsqueeze(-1) == torch.arange(
        attrs["depth"], device=indices.device)
    return hot.to(dt) * (attrs["on_value"] - attrs["off_value"]) \
        + attrs["off_value"]


@register("pick", arg_names=("data", "index"),
          params={"axis": param("shape", (-1,)),
                  "keepdims": param(bool, False),
                  "mode": param(["clip", "wrap"], "clip")})
def _pick(attrs, x, index):
    ax = attrs["axis"]
    axis = int(ax[0]) % x.dim() if ax else x.dim() - 1
    n = x.shape[axis]
    idx = _int_index(index)
    idx = torch.remainder(idx, n) if attrs["mode"] == "wrap" \
        else idx.clamp(0, n - 1)
    out = torch.gather(x, axis, idx.unsqueeze(axis))
    return out if attrs["keepdims"] else out.squeeze(axis)


@register("where", arg_names=("condition", "x", "y"))
def _where(attrs, cond, x, y):
    return torch.where(cond != 0, x, y)


@register("gather_nd", arg_names=("data", "indices"))
def _gather_nd(attrs, data, indices):
    idx = _int_index(indices)
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("scatter_nd", arg_names=("data", "indices"),
          params={"shape": param("shape", (), required=True)})
def _scatter_nd(attrs, data, indices):
    """Zeros of ``shape`` with ``data`` added at ``indices`` (duplicates
    sum, as the reference's ``.at[].add``)."""
    idx = _int_index(indices)
    out = torch.zeros(attrs["shape"], dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data,
                         accumulate=True)


def _not_ported(name):
    def fn(attrs, *xs):
        raise MXNetError("%s is not ported yet: it needs ndarray/sparse.py "
                         "(ROADMAP.md Queue 1 item 9)" % name)
    return fn


register("_contrib_SparseEmbedding", arg_names=("data", "weight"))(
    _not_ported("_contrib_SparseEmbedding"))
register("sparse_retain", aliases=("_sparse_retain",))(
    _not_ported("sparse_retain"))


@register("Cast", aliases=("cast",),
          params={"dtype": param(str, "float32", required=True)})
def _cast(attrs, x):
    return x.to(torch_dtype(attrs["dtype"]))


@register("amp_cast", params={"dtype": param(str, "float32")})
def _amp_cast(attrs, x):
    return x.to(torch_dtype(attrs["dtype"] or "float32"))


@register("ones_like")
def _ones_like(attrs, x):
    return torch.ones_like(x)


@register("shape_array")
def _shape_array(attrs, x):
    return torch.tensor(x.shape, dtype=torch.int64, device=x.device)


@register("size_array")
def _size_array(attrs, x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)


@register("reshape_like", arg_names=("lhs", "rhs"))
def _reshape_like(attrs, x, like):
    return x.reshape(like.shape)


@register("diag", params={"k": param(int, 0)})
def _diag(attrs, x):
    if x.dim() == 1:
        return torch.diag(x, attrs["k"])
    return torch.diagonal(x, offset=attrs["k"], dim1=-2, dim2=-1)


# --------------------------------------------------------------------------
# sequence ops (time on ``axis``, lengths per batch entry)
# --------------------------------------------------------------------------
@register("SequenceMask", aliases=("sequence_mask",),
          params={"use_sequence_length": param(bool, False),
                  "value": param(float, 0.0), "axis": param(int, 0)})
def _sequence_mask(attrs, data, *maybe_len):
    if not attrs["use_sequence_length"] or not maybe_len:
        return data
    ax = attrs["axis"]
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    steps = torch.arange(data.shape[ax], device=data.device).reshape(shape)
    lens = [1] * data.dim()
    lens[1 - ax] = data.shape[1 - ax]
    mask = steps < _int_index(maybe_len[0]).reshape(lens)
    return torch.where(mask, data, torch.full_like(data, attrs["value"]))


@register("SequenceLast", aliases=("sequence_last",),
          params={"use_sequence_length": param(bool, False),
                  "axis": param(int, 0)})
def _sequence_last(attrs, data, *maybe_len):
    ax = attrs["axis"]
    if not attrs["use_sequence_length"] or not maybe_len:
        return data.select(ax, data.shape[ax] - 1)
    idx = (_int_index(maybe_len[0]) - 1).unsqueeze(ax)
    while idx.dim() < data.dim():
        idx = idx.unsqueeze(-1)
    idx = idx.expand(data.shape[:ax] + (1,) + data.shape[ax + 1:])
    return torch.gather(data, ax, idx).squeeze(ax)


@register("SequenceReverse", aliases=("sequence_reverse",),
          params={"use_sequence_length": param(bool, False),
                  "axis": param(int, 0)})
def _sequence_reverse(attrs, data, *maybe_len):
    if not attrs["use_sequence_length"] or not maybe_len:
        return torch.flip(data, dims=(0,))
    lens = _int_index(maybe_len[0])[None, :]
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    idx = torch.where(t < lens, lens - 1 - t, t)
    while idx.dim() < data.dim():
        idx = idx.unsqueeze(-1)
    return torch.gather(data, 0, idx.expand(data.shape))
