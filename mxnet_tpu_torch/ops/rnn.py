"""The fused ``RNN`` op in LSTM mode (counterpart of
``mxnet_tpu/ops/rnn.py``).

Same packed-parameter convention as the reference: one flat vector holding,
for each layer and direction, ``[i2h_W, h2h_W]``, then ``[i2h_bias,
h2h_bias]`` for all of them.  Per layer and direction the input projection
``x @ Wᵀ + bW`` is one ``torch.matmul`` over all T steps, outside the
kernel, as the reference hoists it out of its time loop; the recurrence is
:func:`~mxnet_tpu_torch.ops.hopper_rnn.lstm_recurrence`, kernels 8 and 9 on
the card.  A bidirectional layer runs a second recurrence over the reversed
sequence.  Between layers, in training, inverted dropout draws its mask from
the op's generator.  Gate order ``[i, f, g, o]``, as the reference's.

The modes ``rnn_relu``, ``rnn_tanh`` and ``gru`` have no kernel in the port
yet and raise (``ROADMAP.md`` Queue 1 item 3b).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import hopper_rnn
from .registry import param, register

__all__ = ["rnn_param_size", "dropout"]

_NGATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, state_size, input_size, bidirectional, mode):
    """Length of the packed parameter vector (``rnn.py:26-36``)."""
    ng = _NGATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * ng * state_size * (in_sz + state_size)
    size += num_layers * dirs * 2 * ng * state_size
    return size


def _unpack(params, num_layers, h, input_size, dirs, ng):
    """Views of W, R, bW, bR for each (layer, direction) of the packed
    vector (``rnn.py:39-61``)."""
    out = []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * dirs
        for _ in range(dirs):
            W = params[off:off + ng * h * in_sz].reshape(ng * h, in_sz)
            off += ng * h * in_sz
            R = params[off:off + ng * h * h].reshape(ng * h, h)
            off += ng * h * h
            out.append([W, R, None, None])
    for layer in range(num_layers):
        for d in range(dirs):
            i = layer * dirs + d
            out[i][2] = params[off:off + ng * h]
            off += ng * h
            out[i][3] = params[off:off + ng * h]
            off += ng * h
    return out


def dropout(x, p, generator):
    """Inverted dropout: each element kept with probability ``1 - p`` and
    scaled by ``1 / (1 - p)``, the mask drawn from ``generator``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def _rnn_hint(attrs, shapes):
    """The packed parameters' and the states' shapes from the (T, B, F)
    data's (``shape_hints.py:95``)."""
    data = shapes[0]
    if data is None:
        return shapes
    h, L = attrs["state_size"], attrs["num_layers"]
    bi = attrs["bidirectional"]
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (rnn_param_size(L, h, data[2], bi, attrs["mode"]),)
    for i in (2, 3):
        if len(out) > i and out[i] is None:
            out[i] = (L * (2 if bi else 1), data[1], h)
    return out


@register("RNN", aliases=("rnn",), nout=3, needs_rng=True, train_aware=True,
          arg_names=("data", "parameters", "state", "state_cell"),
          shape_hint=_rnn_hint,
          visible=lambda a: (3 if a["mode"] == "lstm" else 2)
          if a["state_outputs"] else 1,
          params={"state_size": param(int, required=True),
                  "num_layers": param(int, required=True),
                  "bidirectional": param(bool, False),
                  "mode": param(["rnn_relu", "rnn_tanh", "lstm", "gru"],
                                required=True),
                  "p": param(float, 0.0),
                  "state_outputs": param(bool, False),
                  "lstm_state_clip_min": param(float, None),
                  "lstm_state_clip_max": param(float, None),
                  "lstm_state_clip_nan": param(bool, False)})
def _rnn(attrs, generator, data, params, state, *maybe_cell):
    """Fused RNN forward: data (T, B, F) [TNC], state and cell
    (L * dirs, B, h) -> (output (T, B, dirs * h), hT, cT)."""
    mode = attrs["mode"]
    if mode != "lstm":
        raise MXNetError("RNN: mode %r has no kernel in the port yet; only "
                         "'lstm' is ported (ROADMAP.md Queue 1 item 3b)"
                         % mode)
    if not maybe_cell:
        raise MXNetError("RNN: mode 'lstm' needs the cell state input")
    h = attrs["state_size"]
    L = attrs["num_layers"]
    dirs = 2 if attrs["bidirectional"] else 1
    T, B, F = data.shape
    wr = _unpack(params, L, h, F, dirs, _NGATES[mode])
    cell = maybe_cell[0]
    p = attrs["p"] if attrs.get("__train__") else 0.0
    if p > 0 and generator is None:
        raise MXNetError("RNN: dropout in training needs a generator")

    x = data
    hTs, cTs = [], []
    for layer in range(L):
        outs = []
        for d in range(dirs):
            i = layer * dirs + d
            W, R, bW, bR = wr[i]
            xin = x if d == 0 else torch.flip(x, (0,))
            xproj = torch.matmul(xin, W.t()) + bW
            ys, hT, cT = hopper_rnn.lstm_recurrence(xproj, state[i], cell[i],
                                                    R, bR)
            if d == 1:
                ys = torch.flip(ys, (0,))
            outs.append(ys)
            hTs.append(hT)
            if attrs["lstm_state_clip_min"] is not None and \
                    attrs["lstm_state_clip_max"] is not None:
                cT = torch.clamp(cT, attrs["lstm_state_clip_min"],
                                 attrs["lstm_state_clip_max"])
            cTs.append(cT)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if p > 0 and layer < L - 1:
            x = dropout(x, p, generator)
    return x, torch.stack(hTs), torch.stack(cTs)
