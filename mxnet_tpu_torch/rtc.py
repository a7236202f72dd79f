"""Runtime-compiled CUDA kernels (counterpart of ``mxnet_tpu/rtc.py``, whose
``PallasKernel.launch`` runs user Pallas source through ``pl.pallas_call``).

The port turns it back into MXNet's own API (``include/mxnet/rtc.h``,
``src/common/rtc.cc``): the user writes CUDA C, NVRTC compiles it at run
time, and the kernel launches on NDArrays::

    src = r'''
    extern "C" __global__ void axpy(const float *x, float *y, float a,
                                    int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) y[i] += a * x[i];
    }'''
    mod = rtc.CudaModule(src)
    k = mod.get_kernel("axpy", "const float *x, float *y, float a, int n")
    k.launch([x, y, 2.0, n], gpu(0), ((n + 255) // 256, 1, 1), (256, 1, 1))

``CudaModule(source, options=(), exports=())`` compiles once per (source,
options, exports) with NVRTC (``libnvrtc`` of the CUDA toolkit, through
``ctypes``) for ``sm_90a``, with the toolkit's headers on the include
path, and keeps the cubin; ``exports`` names C++
kernels (templates, overloads) whose mangled names NVRTC resolves
(``nvrtcAddNameExpression``/``nvrtcGetLoweredName``); ``extern "C"``
kernels need no export.  ``get_kernel(name, signature)`` parses the C
prototype; ``CudaKernel.launch(args, ctx, grid_dims, block_dims,
shared_mem=0)`` checks each array's dtype and device against it, loads the
module on the device once (``cuModuleLoadData`` in PyTorch's primary
context), and launches on the device's current PyTorch stream; the kernel
writes into the argument arrays.  ``launches`` counts each kernel's
launches.  A CPU context, or a machine without ``libnvrtc`` or
``libcuda``, raises ``MXNetError``; nothing falls back.

``PallasModule``/``PallasKernel`` are the reference's TPU API and raise
here, pointing at ``CudaModule``, as the reference's ``CudaModule``
raises on a TPU.
"""
from __future__ import annotations

import ctypes
import glob
import numbers
import os
import struct
import threading
from collections import namedtuple
from typing import Dict, List, Sequence, Tuple

import torch

from .base import MXNetError
from .context import Context
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "PallasKernel",
           "parse_signature", "pack_args"]

ARCH = "sm_90a"

# C scalar types a signature may name: (torch dtype of a pointer to it,
# ctypes type of a value of it)
_C_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "int": (torch.int32, ctypes.c_int32),
    "signed": (torch.int32, ctypes.c_int32),
    "signed int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "unsigned": (None, ctypes.c_uint32),
    "unsigned int": (None, ctypes.c_uint32),
    "uint32_t": (None, ctypes.c_uint32),
    "long long": (torch.int64, ctypes.c_int64),
    "long long int": (torch.int64, ctypes.c_int64),
    "int64_t": (torch.int64, ctypes.c_int64),
    "unsigned long long": (None, ctypes.c_uint64),
    "uint64_t": (None, ctypes.c_uint64),
    "size_t": (None, ctypes.c_size_t),
    "char": (torch.int8, ctypes.c_int8),
    "int8_t": (torch.int8, ctypes.c_int8),
    "unsigned char": (torch.uint8, ctypes.c_uint8),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "bool": (torch.bool, ctypes.c_bool),
    "__half": (torch.float16, None),
    "half": (torch.float16, None),
    "__nv_bfloat16": (torch.bfloat16, None),
    "nv_bfloat16": (torch.bfloat16, None),
}
_QUALIFIERS = {"const", "volatile", "__restrict__", "__restrict", "restrict"}

Param = namedtuple("Param", ["name", "ctype", "pointer", "const", "dtype"])


def parse_signature(signature: str) -> List[Param]:
    """The parameters of a C prototype such as ``"const float *x, float *y,
    float a, int n"``: one :class:`Param` each, with its C type, whether it
    is a pointer (and to const), and the torch dtype a pointer's array must
    have.  Names are optional; ``*`` may sit on either side of the space.
    Raises ``MXNetError`` on a type it does not know, a pointer to a
    pointer, or a half-precision value passed by value."""
    params = []
    sig = signature.strip()
    if not sig or sig == "void":
        return params
    for i, raw in enumerate(sig.split(",")):
        text = raw.strip()
        stars = text.count("*")
        if stars > 1:
            raise MXNetError("signature %r: parameter %d is a pointer to a "
                             "pointer" % (signature, i))
        words = text.replace("*", " * ").split()
        const = stars == 1 and "const" in words[:words.index("*")]
        name = None
        if stars and words[-1] != "*" and words.index("*") < len(words) - 1:
            name = words[-1]
        words = [w for w in words if w != "*" and w not in _QUALIFIERS]
        if name is not None:
            words = words[:-1]
        ctype = " ".join(words)
        if ctype not in _C_TYPES and len(words) > 1 and not stars:
            ctype, name = " ".join(words[:-1]), words[-1]
        if ctype not in _C_TYPES:
            raise MXNetError("signature %r: unknown type %r in parameter %d"
                             % (signature, ctype, i))
        dtype, cvalue = _C_TYPES[ctype]
        if not stars and cvalue is None:
            raise MXNetError("signature %r: %s can be passed by pointer "
                             "only" % (signature, ctype))
        params.append(Param(name, ctype, bool(stars), const, dtype))
    return params


def pack_args(params: Sequence[Param], args, device: torch.device):
    """The ``kernelParams`` of a launch: a ``void*[]`` whose entries point
    at each argument's value (a device pointer for an array, the C value
    for a scalar), and the ctypes objects that hold those values, which
    must live until the launch returns.  Each array must be a contiguous
    tensor (or NDArray) of the pointer's dtype on ``device``; each scalar a
    Python number.  Raises ``MXNetError`` otherwise."""
    if len(args) != len(params):
        raise MXNetError("kernel takes %d arguments, got %d"
                         % (len(params), len(args)))
    holders = []
    for i, (p, a) in enumerate(zip(params, args)):
        label = "argument %d (%s)" % (i, p.name or p.ctype)
        if p.pointer:
            t = a._data if isinstance(a, NDArray) else a
            if not isinstance(t, torch.Tensor):
                raise MXNetError("%s is a %s pointer, got %s"
                                 % (label, p.ctype, type(a).__name__))
            if p.dtype is None or t.dtype != p.dtype:
                raise MXNetError("%s is a %s pointer, the array is %s"
                                 % (label, p.ctype, t.dtype))
            if t.device != device:
                raise MXNetError("%s lies on %s, the launch is on %s"
                                 % (label, t.device, device))
            if not t.is_contiguous():
                raise MXNetError("%s is not contiguous" % label)
            holders.append(ctypes.c_void_p(t.data_ptr()))
        else:
            if not isinstance(a, numbers.Real):
                raise MXNetError("%s is a %s value, got %s"
                                 % (label, p.ctype, type(a).__name__))
            cvalue = _C_TYPES[p.ctype][1]
            if cvalue not in (ctypes.c_float, ctypes.c_double) and \
                    not isinstance(a, numbers.Integral):
                raise MXNetError("%s is a %s, got the float %r"
                                 % (label, p.ctype, a))
            holders.append(cvalue(a))
    pack = (ctypes.c_void_p * max(1, len(holders)))(
        *[ctypes.addressof(h) for h in holders])
    return pack, holders


# --------------------------------------------------------------------------
# NVRTC and libcuda through ctypes
# --------------------------------------------------------------------------
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}

_P = ctypes.POINTER
_VOID, _INT, _UINT, _STR = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                            ctypes.c_char_p)
# every entry point rtc calls: (library, result type, argument types)
_SIGNATURES = {
    "nvrtcCreateProgram": ("nvrtc", _INT, [_P(_VOID), _STR, _STR, _INT,
                                           _VOID, _VOID]),
    "nvrtcAddNameExpression": ("nvrtc", _INT, [_VOID, _STR]),
    "nvrtcCompileProgram": ("nvrtc", _INT, [_VOID, _INT, _P(_STR)]),
    "nvrtcGetProgramLogSize": ("nvrtc", _INT, [_VOID, _P(ctypes.c_size_t)]),
    "nvrtcGetProgramLog": ("nvrtc", _INT, [_VOID, _STR]),
    "nvrtcGetCUBINSize": ("nvrtc", _INT, [_VOID, _P(ctypes.c_size_t)]),
    "nvrtcGetCUBIN": ("nvrtc", _INT, [_VOID, _STR]),
    "nvrtcGetLoweredName": ("nvrtc", _INT, [_VOID, _STR, _P(_STR)]),
    "nvrtcDestroyProgram": ("nvrtc", _INT, [_P(_VOID)]),
    "nvrtcGetErrorString": ("nvrtc", _STR, [_INT]),
    "cuInit": ("cuda", _INT, [_UINT]),
    "cuDeviceGet": ("cuda", _INT, [_P(_INT), _INT]),
    "cuDevicePrimaryCtxRetain": ("cuda", _INT, [_P(_VOID), _INT]),
    "cuCtxPushCurrent": ("cuda", _INT, [_VOID]),
    "cuCtxPopCurrent": ("cuda", _INT, [_P(_VOID)]),
    "cuModuleLoadData": ("cuda", _INT, [_P(_VOID), _STR]),
    "cuModuleGetFunction": ("cuda", _INT, [_P(_VOID), _VOID, _STR]),
    "cuLaunchKernel": ("cuda", _INT, [_VOID] + [_UINT] * 7
                       + [_VOID, _P(_VOID), _P(_VOID)]),
    "cuGetErrorString": ("cuda", _INT, [_INT, _P(_STR)]),
}


def _cuda_roots() -> List[str]:
    return [r for r in (os.environ.get("CUDA_HOME"),
                        os.environ.get("CUDA_PATH"), "/usr/local/cuda") if r]


def _include_options() -> List[str]:
    """``--include-path`` of the toolkit's headers (``cuda_fp16.h``,
    ``cuda_bf16.h``), which NVRTC does not search by itself."""
    return ["--include-path=" + os.path.join(root, "include")
            for root in _cuda_roots()
            if os.path.exists(os.path.join(root, "include", "cuda_bf16.h"))
            ][:1]


def _nvrtc_candidates() -> List[str]:
    found = []
    for root in _cuda_roots():
        for sub in ("lib64", "lib", "targets/x86_64-linux/lib"):
            found += sorted(glob.glob(os.path.join(root, sub,
                                                   "libnvrtc.so*")))
    return found + ["libnvrtc.so", "libnvrtc.so.12"]


def _load(kind: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(kind)
        if lib is not None:
            return lib
        names = _nvrtc_candidates() if kind == "nvrtc" \
            else ["libcuda.so.1", "libcuda.so"]
        for name in names:
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                continue
        if lib is None:
            raise MXNetError("rtc: lib%s was not found (tried %s); "
                             "CudaModule needs the CUDA toolkit's NVRTC and "
                             "libcuda" % (kind, ", ".join(names)))
        _libs[kind] = lib
        return lib


def _fn(name):
    """Entry point ``name`` of NVRTC or libcuda, with its argument and
    result types declared; a libcuda function by its current (``_v2``)
    symbol where libcuda has one, as ``cuda.h`` maps it."""
    fn = _fns.get(name)
    if fn is None:
        kind, restype, argtypes = _SIGNATURES[name]
        lib = _load(kind)
        fn = getattr(lib, name + "_v2", None) or getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
        _fns[name] = fn
    return fn


def _nvrtc_check(res, what, log=""):
    if res != 0:
        msg = _fn("nvrtcGetErrorString")(res).decode()
        raise MXNetError("NVRTC %s failed: %s%s" % (
            what, msg, ("\n" + log) if log else ""))


def _cu_check(res, what):
    if res != 0:
        s = ctypes.c_char_p()
        _fn("cuGetErrorString")(res, ctypes.byref(s))
        raise MXNetError("libcuda %s failed: %s (%d)" % (
            what, s.value.decode() if s.value else "unknown error", res))


Program = namedtuple("Program", ["cubin", "lowered", "functions",
                                 "seconds"])


def _elf_functions(image: bytes) -> set:
    """The function symbols of an ELF64 image (a cubin's kernels, by their
    mangled names)."""
    if image[:4] != b"\x7fELF" or image[4] != 2:
        raise MXNetError("rtc: NVRTC returned no ELF64 cubin")
    shoff, = struct.unpack_from("<Q", image, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", image, 0x3A)

    def section(i):
        _, stype, _, _, off, size, link, _, _, entsize = struct.unpack_from(
            "<IIQQQQIIQQ", image, shoff + i * shentsize)
        return stype, off, size, link, entsize

    names = set()
    for i in range(shnum):
        stype, off, size, link, entsize = section(i)
        if stype != 2:                            # SHT_SYMTAB
            continue
        _, stroff, _, _, _ = section(link)
        for j in range(size // entsize):
            st_name, st_info = struct.unpack_from("<IB", image,
                                                  off + j * entsize)
            if st_info & 0xF == 2:                # STT_FUNC
                end = image.index(b"\0", stroff + st_name)
                names.add(image[stroff + st_name:end].decode())
    return names


def _compile(source: str, options: Tuple[str, ...],
             exports: Tuple[str, ...]) -> Program:
    """Compile ``source`` with NVRTC for ``sm_90a``: the cubin, the lowered
    name of each export, the cubin's kernels and the seconds it took."""
    import time
    t0 = time.perf_counter()
    prog = ctypes.c_void_p()
    _nvrtc_check(_fn("nvrtcCreateProgram")(
        ctypes.byref(prog), source.encode(), b"rtc_module.cu", 0, None,
        None), "nvrtcCreateProgram")
    try:
        for name in exports:
            _nvrtc_check(_fn("nvrtcAddNameExpression")(prog, name.encode()),
                         "nvrtcAddNameExpression(%s)" % name)
        opts = [o.encode() for o in ["--gpu-architecture=" + ARCH]
                + _include_options() + list(options)]
        res = _fn("nvrtcCompileProgram")(
            prog, len(opts), (ctypes.c_char_p * len(opts))(*opts))
        size = ctypes.c_size_t()
        _fn("nvrtcGetProgramLogSize")(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value)
        _fn("nvrtcGetProgramLog")(prog, buf)
        _nvrtc_check(res, "compile", buf.value.decode(errors="replace"))
        _nvrtc_check(_fn("nvrtcGetCUBINSize")(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(_fn("nvrtcGetCUBIN")(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name in exports:
            out = ctypes.c_char_p()
            _nvrtc_check(_fn("nvrtcGetLoweredName")(
                prog, name.encode(), ctypes.byref(out)),
                "nvrtcGetLoweredName(%s)" % name)
            lowered[name] = out.value.decode()
    finally:
        _fn("nvrtcDestroyProgram")(ctypes.byref(prog))
    image = cubin.raw
    return Program(image, lowered, _elf_functions(image),
                   time.perf_counter() - t0)


_programs: Dict[tuple, Program] = {}
_primary: Dict[int, ctypes.c_void_p] = {}


def _context(index: int) -> ctypes.c_void_p:
    """PyTorch's primary context of device ``index`` (made by torch first,
    then retained), which sees torch's pointers."""
    ctx = _primary.get(index)
    if ctx is None:
        torch.cuda.init()
        torch.empty(1, device=torch.device("cuda", index))
        _cu_check(_fn("cuInit")(0), "cuInit")
        dev = ctypes.c_int()
        _cu_check(_fn("cuDeviceGet")(ctypes.byref(dev), index),
                  "cuDeviceGet")
        ctx = ctypes.c_void_p()
        _cu_check(_fn("cuDevicePrimaryCtxRetain")(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _primary[index] = ctx
    return ctx


class CudaModule:
    """CUDA C source compiled by NVRTC (``rtc.h:39``); see the module
    docstring.  Compiled programs are cached by (source, options,
    exports)."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        key = (source, self.options, self.exports)
        program = _programs.get(key)
        if program is None:
            program = _programs[key] = _compile(source, self.options,
                                                self.exports)
        self.program = program
        self._modules: Dict[int, ctypes.c_void_p] = {}

    @property
    def compile_seconds(self) -> float:
        return self.program.seconds

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` (an ``extern "C"`` name or one of
        ``exports``) with its C prototype; raises when the module has no
        such kernel."""
        symbol = self.program.lowered.get(name, name)
        if symbol not in self.program.functions:
            raise MXNetError("rtc: kernel %r not found in the module (its "
                             "kernels: %s; C++ names need exports=)"
                             % (name, sorted(self.program.functions)))
        return CudaKernel(self, name, symbol, parse_signature(signature))

    def _module(self, index: int) -> ctypes.c_void_p:
        """The cubin loaded on device ``index`` (its context current)."""
        mod = self._modules.get(index)
        if mod is None:
            mod = ctypes.c_void_p()
            _cu_check(_fn("cuModuleLoadData")(ctypes.byref(mod),
                                              self.program.cubin),
                      "cuModuleLoadData")
            self._modules[index] = mod
        return mod


class CudaKernel:
    """One kernel of a :class:`CudaModule` (``rtc.h:82``); ``launches``
    counts its launches."""

    def __init__(self, module: CudaModule, name: str, symbol: str,
                 params: List[Param]):
        self.module = module
        self.name = name
        self.symbol = symbol
        self.params = params
        self.launches = 0
        self._functions: Dict[int, ctypes.c_void_p] = {}

    def launch(self, args, ctx: Context, grid_dims, block_dims,
               shared_mem: int = 0):
        """Launch on ``ctx`` (a GPU context) over ``grid_dims`` blocks of
        ``block_dims`` threads (each up to 3 ints) with ``shared_mem``
        bytes of dynamic shared memory, on the device's current PyTorch
        stream; the kernel writes into the argument arrays."""
        if not isinstance(ctx, Context) or ctx.device_type != "gpu":
            raise MXNetError("CudaKernel.launch needs a GPU context, got %r"
                             % (ctx,))
        device = ctx.torch_device
        grid = tuple(grid_dims) + (1,) * (3 - len(grid_dims))
        block = tuple(block_dims) + (1,) * (3 - len(block_dims))
        pack, holders = pack_args(self.params, args, device)
        _cu_check(_fn("cuCtxPushCurrent")(_context(device.index)),
                  "cuCtxPushCurrent")
        try:
            fn = self._functions.get(device.index)
            if fn is None:
                fn = ctypes.c_void_p()
                _cu_check(_fn("cuModuleGetFunction")(
                    ctypes.byref(fn), self.module._module(device.index),
                    self.symbol.encode()), "cuModuleGetFunction")
                self._functions[device.index] = fn
            stream = ctypes.c_void_p(
                torch.cuda.current_stream(device).cuda_stream)
            _cu_check(_fn("cuLaunchKernel")(
                fn, *[ctypes.c_uint(v) for v in grid],
                *[ctypes.c_uint(v) for v in block],
                ctypes.c_uint(shared_mem), stream, pack, None),
                "cuLaunchKernel(%s)" % self.name)
            self.launches += 1
        finally:
            _cu_check(_fn("cuCtxPopCurrent")(
                ctypes.byref(ctypes.c_void_p())), "cuCtxPopCurrent")
        del holders


class PallasModule:
    """The reference's TPU API; raises here."""

    def __init__(self, *a, **kw):
        raise MXNetError("PallasModule compiles Pallas kernels for a TPU; "
                         "on the GPU use mx.rtc.CudaModule with CUDA C "
                         "source (NVRTC)")


PallasKernel = PallasModule
