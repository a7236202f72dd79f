"""Gluon fused recurrent layers (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``): ``LSTM`` over the fused ``RNN`` op,
whose recurrence runs on kernels 8 and 9 on the card.

The layer keeps the reference's parameter names (``l0_i2h_weight`` ...
``l1_h2h_bias``, ``r0_...`` for the reverse direction), its packed-parameter
graph and its call contract: ``layer(x)`` returns the output alone,
``layer(x, states)`` returns ``(output, new_states)``.  The input size may
be left to the first batch: a HybridBlock's NDArray call first infers
parameter shapes, and this layer's inference takes the input size from the
data before it builds its graph (``_infer_out_shape``), which is what lets
``HybridSequential`` resolve it too.
"""
from __future__ import annotations

from ... import ndarray
from ... import symbol as _symbol
from ...base import MXNetError
from ...symbol import Symbol
from ..block import HybridBlock

__all__ = ["LSTM"]


class _RNNLayer(HybridBlock):
    """Fused recurrent layer over the ``RNN`` op (``rnn_layer.py:20-234``)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError("invalid layout %s; must be 'TNC' or 'NTC'"
                             % layout)
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        self._state_graph = None

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param("{}{}_i2h_weight".format(j, i),
                                     (ng * nh, ni), i2h_weight_initializer)
                self._register_param("{}{}_h2h_weight".format(j, i),
                                     (ng * nh, nh), h2h_weight_initializer)
                self._register_param("{}{}_i2h_bias".format(j, i),
                                     (ng * nh,), i2h_bias_initializer)
                self._register_param("{}{}_h2h_bias".format(j, i),
                                     (ng * nh,), h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def _collect_params_with_prefix(self, prefix=""):
        """Flat per-layer names, as the reference's checkpoints hold them."""
        if prefix:
            prefix += "."
        return {prefix + key: val for key, val in self._reg_params.items()}

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=ndarray.zeros, **kwargs):
        """Initial recurrent states, one array per ``state_info`` entry."""
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            info = dict(info or {}, **kwargs)
            states.append(func(name="%sh0_%d" % (self.prefix, i), **info))
        return states

    def _set_input_size(self, size):
        """Resolve a deferred input size (``rnn_layer.py:136-150``)."""
        if self._input_size == 0:
            for j in ["l", "r"][:self._dir]:
                self.params.get("%s0_i2h_weight" % j).shape = (
                    self._gates * self._hidden_size, size)
            self._input_size = size

    def _infer_out_shape(self, in_shape):
        self._set_input_size(in_shape[2])
        return super()._infer_out_shape(in_shape)

    def __call__(self, inputs, *states):
        if isinstance(inputs, Symbol) and self._input_size == 0:
            raise MXNetError(
                "symbolic use of %s with unknown input size: pass "
                "input_size= at construction or run one batch first to "
                "resolve deferred shapes" % type(self).__name__)
        skip_states = states in ((), (None,))
        if skip_states:
            return self.forward(inputs)
        if len(states) == 1 and isinstance(states[0], (list, tuple)):
            states = states[0]
        states = list(states)
        if isinstance(inputs, Symbol):
            with self.name_scope():
                return self._forward_kernel(inputs, states)
        return self._call_with_states(inputs, states)

    def hybrid_forward(self, F, x, **params):
        """The output alone, zero initial states (the graph of ``layer(x)``)."""
        return self._forward_kernel(x, [])[0]

    def _call_with_states(self, inputs, states):
        """``layer(x, states)`` on NDArrays: (output, new states) through a
        graph with the states as inputs."""
        from ...cached_op import CachedOp
        batch = inputs.shape[self._layout.find("N")]
        for state, info in zip(states, self.state_info(batch)):
            if state.shape != info["shape"]:
                raise MXNetError("invalid recurrent state shape: expected "
                                 "%s, got %s" % (info["shape"], state.shape))
        params = self.collect_params()
        if any(p._deferred_init for p in params.values()):
            self.infer_shape(inputs)
            for p in params.values():
                p._finish_deferred_init()
        if self._state_graph is None:
            data = _symbol.var("data")
            svars = [_symbol.var("state%d" % i) for i in range(len(states))]
            with self.name_scope():
                out, new = self._forward_kernel(data, svars)
            group = _symbol.Group([out] + new)
            self._state_graph = CachedOp(group), len(new)
        op, n_new = self._state_graph
        given = {"data": inputs}
        given.update(("state%d" % i, s) for i, s in enumerate(states))
        outs = op(*[given[n] if n in given else params[n].data()
                    for n in op.input_names])
        return outs[0], list(outs[1:1 + n_new])

    def _forward_kernel(self, inputs, states):
        """The packed-parameter graph of the fused op (``rnn_layer.py:
        191-234``) on Symbols: (output, new states)."""
        F = _symbol
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, 0, 1)

        def flat_param(name):
            return getattr(self, name).var().reshape((-1,))

        ws, bs = [], []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                ws.append(flat_param("{}{}_i2h_weight".format(j, i)))
                ws.append(flat_param("{}{}_h2h_weight".format(j, i)))
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                bs.append(flat_param("{}{}_i2h_bias".format(j, i)))
                bs.append(flat_param("{}{}_h2h_bias".format(j, i)))
        params = F.concat(*(ws + bs), dim=0)

        if not states:
            # (L * dirs, B, h) zeros with B taken from the data
            z = F.zeros_like(F.mean(inputs, axis=(0, 2), keepdims=True))
            z = F.broadcast_axis(
                z, axis=(0, 2),
                size=(self._num_layers * self._dir, self._hidden_size))
            states = [z, z] if self._mode == "lstm" else [z]

        outputs = F.RNN(inputs, params, *states, state_size=self._hidden_size,
                        num_layers=self._num_layers,
                        bidirectional=self._dir == 2, p=self._dropout,
                        state_outputs=True, mode=self._mode)
        if self._mode == "lstm":
            outputs, states = outputs[0], [outputs[1], outputs[2]]
        else:
            outputs, states = outputs[0], [outputs[1]]
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, 0, 1)
        return outputs, states


class LSTM(_RNNLayer):
    """Multi-layer LSTM (``rnn_layer.py:255-278``)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]
