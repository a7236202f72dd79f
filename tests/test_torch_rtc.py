"""``mx.rtc`` of the port: CUDA C compiled at run time by NVRTC
(``CudaModule``/``CudaKernel``), the counterpart of the reference's
``PallasModule``/``PallasKernel`` (TPU kernel 11).

Here, without NVRTC or a card: the signature parser (each C type,
qualifier and ``*`` placement it takes, and what it refuses), the argument
pack a launch hands ``cuLaunchKernel`` (each entry points at the value of
its argument), and the errors — a CPU context, a missing ``libnvrtc``, a
dtype, device, layout or count mismatch, a kernel the module does not
export — with the compile step replaced by a stub.  On a card (``cuda``
marker): the reference's three test bodies in CUDA, axpy and a bf16
scale against their PyTorch expressions, exact (fp32) and within one
bf16 ulp."""
import ctypes

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError


@pytest.mark.parametrize("sig,want", [
    ("const float *x, float *y, float a, int n",
     [("x", "float", True, True, torch.float32),
      ("y", "float", True, False, torch.float32),
      ("a", "float", False, False, torch.float32),
      ("n", "int", False, False, torch.int32)]),
    ("float* y", [("y", "float", True, False, torch.float32)]),
    ("float const * __restrict__ x, double d",
     [("x", "float", True, True, torch.float32),
      ("d", "double", False, False, torch.float64)]),
    ("const __nv_bfloat16 *src, __nv_bfloat16 *dst, __half *h",
     [("src", "__nv_bfloat16", True, True, torch.bfloat16),
      ("dst", "__nv_bfloat16", True, False, torch.bfloat16),
      ("h", "__half", True, False, torch.float16)]),
    ("int32_t a, int64_t b, long long c, unsigned u, unsigned int v",
     [("a", "int32_t", False, False, torch.int32),
      ("b", "int64_t", False, False, torch.int64),
      ("c", "long long", False, False, torch.int64),
      ("u", "unsigned", False, False, None),
      ("v", "unsigned int", False, False, None)]),
    ("const float *, int", [(None, "float", True, True, torch.float32),
                            (None, "int", False, False, torch.int32)]),
    ("void", []),
], ids=["axpy", "star-left", "const-right", "half", "ints", "unnamed",
        "void"])
def test_parse_signature(sig, want):
    assert [tuple(p) for p in rtc.parse_signature(sig)] == want


@pytest.mark.parametrize("sig", ["float **x", "quad x", "__half h",
                                 "const mystruct *p"])
def test_parse_signature_refuses(sig):
    with pytest.raises(MXNetError):
        rtc.parse_signature(sig)


def _value(pack, i, ctype):
    return ctypes.cast(pack[i], ctypes.POINTER(ctype)).contents.value


def test_pack_args_points_at_each_value():
    params = rtc.parse_signature("const float *x, float *y, float a, int n, "
                                 "long long m, double d")
    x, y = torch.arange(4.0), torch.zeros(4)
    pack, holders = rtc.pack_args(
        params, [tmx.nd.NDArray(x), y, 2.5, 7, 2 ** 40, 0.125],
        torch.device("cpu"))
    assert len(holders) == 6
    assert _value(pack, 0, ctypes.c_void_p) == x.data_ptr()
    assert _value(pack, 1, ctypes.c_void_p) == y.data_ptr()
    assert _value(pack, 2, ctypes.c_float) == 2.5
    assert _value(pack, 3, ctypes.c_int32) == 7
    assert _value(pack, 4, ctypes.c_int64) == 2 ** 40
    assert _value(pack, 5, ctypes.c_double) == 0.125


@pytest.mark.parametrize("args,match", [
    ([torch.zeros(4, dtype=torch.float64), 3], "float pointer"),
    ([torch.zeros(4), 2.5], "got the float"),
    ([torch.zeros(4), "3"], "value"),
    ([3, 3], "pointer"),
    ([torch.zeros(4, 2).t(), 3], "contiguous"),
    ([torch.zeros(4, device="meta"), 3], "lies on"),
    ([torch.zeros(4)], "takes 2 arguments"),
], ids=["dtype", "int-from-float", "string", "scalar-for-array",
        "strided", "device", "count"])
def test_pack_args_refuses(args, match):
    with pytest.raises(MXNetError, match=match):
        rtc.pack_args(rtc.parse_signature("float *x, int n"), args,
                      torch.device("cpu"))


def _stub_compile(monkeypatch, functions, lowered=None):
    calls = []

    def fake(source, options, exports):
        calls.append((source, options, exports))
        return rtc.Program(b"", dict(lowered or {}), set(functions), 0.0)

    monkeypatch.setattr(rtc, "_compile", fake)
    monkeypatch.setattr(rtc, "_programs", {})
    return calls


def test_module_kernels_exports_and_cpu_context(monkeypatch):
    """``get_kernel`` finds an ``extern "C"`` name or an export's lowered
    name and raises for any other; programs are cached by (source,
    options, exports); a launch on a CPU context raises."""
    calls = _stub_compile(monkeypatch, {"add_one", "_Z5scaleIfEvPT_i"},
                          {"scale<float>": "_Z5scaleIfEvPT_i"})
    src = 'extern "C" __global__ void add_one(float *x, int n) {}'
    mod = rtc.CudaModule(src, exports=["scale<float>"])
    rtc.CudaModule(src, exports=["scale<float>"])
    rtc.CudaModule(src, options=["-lineinfo"], exports=["scale<float>"])
    assert len(calls) == 2
    k = mod.get_kernel("add_one", "float *x, int n")
    assert k.symbol == "add_one" and k.launches == 0
    assert mod.get_kernel("scale<float>", "float *x, int n").symbol == \
        "_Z5scaleIfEvPT_i"
    with pytest.raises(MXNetError, match="not found"):
        mod.get_kernel("nope", "float *x")
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([torch.zeros(4), 4], tmx.cpu(), (1,), (4,))
    assert k.launches == 0


def test_missing_nvrtc_raises(monkeypatch):
    monkeypatch.setattr(rtc, "_libs", {})
    monkeypatch.setattr(rtc, "_fns", {})
    monkeypatch.setattr(rtc, "_programs", {})
    monkeypatch.setattr(rtc, "_nvrtc_candidates",
                        lambda: ["/nonexistent/libnvrtc.so.99"])
    with pytest.raises(MXNetError, match="libnvrtc"):
        rtc.CudaModule('extern "C" __global__ void f() {}')


def test_pallas_module_points_at_cuda_module():
    """The reference's TPU API raises here, as its CudaModule raises on a
    TPU (``mxnet_tpu/rtc.py:125-132``)."""
    with pytest.raises(MXNetError, match="CudaModule"):
        rtc.PallasModule("def k(x_ref, o_ref): pass")
    with pytest.raises(mx.MXNetError):
        mx.rtc.CudaModule("__global__ void f(){}")


@pytest.mark.cuda
def test_user_kernels_on_the_card():
    """add-one, the row scale over a grid of 4, a missing export, axpy and
    a bf16 scale, each against its PyTorch expression (fp32 exact, bf16
    within one ulp), compiled with ``--fmad=false``; ``launches`` counts
    each launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 2f runs the "
                    "same kernels on the H100")
    src = r'''
    #include <cuda_bf16.h>
    extern "C" __global__ void add_one(const float *x, float *y, int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) y[i] = x[i] + 1.0f;
    }
    extern "C" __global__ void axpy(const float *x, float *y, float a,
                                    int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) y[i] += a * x[i];
    }
    template <typename T>
    __global__ void scale(const T *x, T *y, float s, int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) y[i] = T(float(x[i]) * s);
    }'''
    # without FMA contraction, axpy rounds its product and its sum apart,
    # as PyTorch's y0 + a * x does (chip_smoke.py phase 2f compiles the same
    # way)
    mod = rtc.CudaModule(src, options=("--fmad=false",),
                         exports=["scale<__nv_bfloat16>"])
    ctx, dev = tmx.gpu(0), torch.device("cuda", 0)
    x = torch.randn(1000, device=dev)
    y = torch.empty_like(x)
    k = mod.get_kernel("add_one", "const float *x, float *y, int n")
    k.launch([x, y, 1000], ctx, (4,), (256,))
    assert torch.equal(y, x + 1.0) and k.launches == 1
    y0 = torch.randn(1000, device=dev)
    y = y0.clone()
    mod.get_kernel("axpy", "const float *x, float *y, float a, int n") \
        .launch([x, y, 3.0, 1000], ctx, (4,), (256,))
    assert torch.equal(y, y0 + torch.tensor(3.0) * x)
    xb = torch.randn(1000, device=dev).to(torch.bfloat16)
    yb = torch.empty_like(xb)
    mod.get_kernel("scale<__nv_bfloat16>", "const __nv_bfloat16 *x, "
                   "__nv_bfloat16 *y, float s, int n") \
        .launch([xb, yb, 0.3, 1000], ctx, (4,), (256,))
    want = (xb.float() * 0.3).to(torch.bfloat16)
    ulp = torch.finfo(torch.bfloat16).eps * want.float().abs()
    assert ((yb.float() - want.float()).abs() <= ulp).all()
    with pytest.raises(MXNetError):
        mod.get_kernel("scale", "const float *x")
