"""Inference-only predict API (counterpart of ``mxnet_tpu/predictor.py``):
create a predictor from a symbol JSON, a parameter blob and input shapes,
then ``set_input -> forward -> get_output``.
"""
from __future__ import annotations

import io

from .base import MXNetError
from .context import current_context
from .ndarray import ndarray as nd
from .ndarray.ndarray import NDArray

__all__ = ["Predictor", "load_ndarray_file"]


def load_ndarray_file(nd_bytes: bytes, ctx=None):
    """Load a parameter blob (the ``nd.save`` format) into a dict on
    ``ctx`` (default: the current context)."""
    return nd.load(io.BytesIO(nd_bytes), ctx)


class Predictor:
    """Forward-only executor (parity: MXPredCreate family).

    Parameters
    ----------
    symbol_json : str
        Symbol JSON (the string itself or a path ending in .json).
    params : bytes | dict | str
        Parameter blob bytes (save format), a {name: NDArray} dict (with
        optional ``arg:``/``aux:`` name prefixes, checkpoint convention),
        or a path to a .params file.
    ctx : Context, optional
        Defaults to the current context, ``gpu(0)`` unless a ``with ctx:``
        scope says otherwise.
    input_shapes : dict of name -> shape
    """

    def __init__(self, symbol_json, params, ctx=None, input_shapes=None):
        from . import symbol as sym_mod

        self._ctx = ctx or current_context()
        if isinstance(symbol_json, str) and symbol_json.endswith(".json"):
            with open(symbol_json) as f:
                symbol_json = f.read()
        self._symbol = sym_mod.load_json(symbol_json)

        if isinstance(params, (bytes, bytearray)):
            loaded = load_ndarray_file(bytes(params), self._ctx)
        elif isinstance(params, str):
            loaded = nd.load(params, self._ctx)
        else:
            loaded = dict(params)
        self._arg_params = {}
        self._aux_params = {}
        for k, v in loaded.items():
            if not isinstance(v, NDArray):
                v = nd.array(v, ctx=self._ctx)
            if k.startswith("arg:"):
                self._arg_params[k[4:]] = v
            elif k.startswith("aux:"):
                self._aux_params[k[4:]] = v
            else:
                self._arg_params[k] = v
        self._bind(input_shapes)

    def _bind(self, input_shapes):
        """Bind the parsed symbol and params for these input shapes."""
        input_shapes = dict(input_shapes or {})
        if not input_shapes:
            raise MXNetError("Predictor needs input_shapes (e.g. "
                             "{'data': (1, 3, 224, 224)})")
        self._input_names = list(input_shapes)
        arg_names = self._symbol.list_arguments()
        aux_names = self._symbol.list_auxiliary_states()
        self._symbol.infer_shape(**input_shapes)
        args = {}
        for name in arg_names:
            if name in input_shapes:
                args[name] = nd.zeros(input_shapes[name], ctx=self._ctx)
            elif name in self._arg_params:
                args[name] = self._arg_params[name].as_in_context(self._ctx)
            else:
                raise MXNetError("missing parameter %r" % name)
        auxs = {}
        for name in aux_names:
            if name in self._aux_params:
                auxs[name] = self._aux_params[name].as_in_context(self._ctx)
            else:
                # zero-filling e.g. BatchNorm moving_var would silently
                # produce garbage inference: fail like the arg path does
                raise MXNetError("missing auxiliary state %r" % name)
        self._executor = self._symbol.bind(self._ctx, args, aux_states=auxs)
        self._outputs = None

    def set_input(self, name, value):
        """MXPredSetInput.  An NDArray is adopted as is (moved only when it
        lies on another device, cast only when its dtype differs), so a
        batch already on the card takes no host round trip; anything else
        is copied in from the host."""
        if name not in self._input_names:
            raise MXNetError("unknown input %r (have %s)"
                             % (name, self._input_names))
        dst = self._executor.arg_dict[name]
        if isinstance(value, NDArray):
            if value.shape != dst.shape:
                raise MXNetError("input %r has shape %s, bound shape is %s"
                                 % (name, value.shape, dst.shape))
            dst._data = value._data.to(dst._data.device, dst._data.dtype)
        else:
            dst[:] = value

    def forward(self, **inputs):
        """MXPredForward; keyword inputs are a convenience for set_input."""
        for k, v in inputs.items():
            self.set_input(k, v)
        self._outputs = self._executor.forward(is_train=False)
        return self._outputs

    def get_output(self, index=0):
        """MXPredGetOutput."""
        if self._outputs is None:
            raise MXNetError("call forward() before get_output()")
        return self._outputs[index]

    def reshape(self, input_shapes):
        """MXPredReshape: rebind for new input shapes, sharing this
        predictor's symbol and parameter tensors (no copies)."""
        new = Predictor.__new__(Predictor)
        new._ctx = self._ctx
        new._symbol = self._symbol
        new._arg_params = self._arg_params
        new._aux_params = self._aux_params
        new._bind(input_shapes)
        return new

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=True):
        """Copy new weights into the bound executor (the hot-swap path),
        then re-point the shared parameter dicts at the live bound arrays
        (``predictor.py:242-273``): a copy made at bind (parameters given on
        another device) would otherwise pin a dead weight set on the card
        across every later swap.  The bucket predictors of a server share
        these dicts and, on one device, the bound arrays themselves, so one
        copy of the weights serves them all."""
        self._executor.copy_params_from(arg_params, aux_params,
                                        allow_extra_params)
        for name, arr in self._executor.arg_dict.items():
            if name not in self._input_names and name in self._arg_params:
                self._arg_params[name] = arr
        for name, arr in self._executor.aux_dict.items():
            if name in self._aux_params:
                self._aux_params[name] = arr
