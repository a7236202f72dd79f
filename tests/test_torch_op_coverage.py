"""Registry coverage of the port against the reference, on the CPU.

Every op name that ``mxnet_tpu/ops/init_random.py``, ``nn.py`` and
``misc_parity.py`` register is registered in the port
(``mxnet_tpu_torch.ops.registry.OPS``), and the only names of
``mxnet_tpu.ops.registry.list_ops()`` still missing there are those of
ROADMAP.md's Queue 1 item 9, listed below by the reference module that
defines them.  A name ported later leaves ``ITEM_9``; a name the reference
gains, or one the port drops, fails the test.
"""
import pytest

import mxnet_tpu  # noqa: F401  (registers the reference's ops)
from mxnet_tpu.ops import registry as ref_registry
from mxnet_tpu_torch.ops.registry import OPS

#: the reference's names the port does not register yet, by defining
#: module: item 9's operators (detection, contrib extras, control flow,
#: linalg, int8, spatial, the fork's vision ops, ``Custom``)
ITEM_9 = {
    "mxnet_tpu.operator": (
        "Custom",),
    "mxnet_tpu.ops.contrib_det": (
        "DeformableConvolution", "DeformablePSROIPooling",
        "MultiBoxDetection", "MultiBoxPrior", "MultiBoxTarget",
        "MultiProposal", "PSROIPooling", "Proposal", "ROIAlign",
        "ROIPooling", "_contrib_DeformableConvolution",
        "_contrib_DeformablePSROIPooling", "_contrib_MultiBoxDetection",
        "_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
        "_contrib_MultiProposal", "_contrib_PSROIPooling",
        "_contrib_Proposal", "_contrib_ROIAlign",
        "_contrib_bipartite_matching", "_contrib_box_iou",
        "_contrib_box_nms", "_contrib_box_non_maximum_suppression",
        "bipartite_matching", "box_iou", "box_nms", "roipooling",),
    "mxnet_tpu.ops.contrib_misc": (
        "AdaptiveAvgPooling2D", "BilinearResize2D", "CTCLoss",
        "ChannelOperator", "_contrib_AdaptiveAvgPooling2D",
        "_contrib_BilinearResize2D", "_contrib_CTCLoss",
        "_contrib_ChannelOperator", "_contrib_count_sketch",
        "_contrib_ctc_loss", "_contrib_div_sqrt_dim", "_contrib_fft",
        "_contrib_ifft", "_contrib_quadratic", "count_sketch", "ctc_loss",
        "div_sqrt_dim", "fft", "ifft", "khatri_rao", "quadratic",),
    "mxnet_tpu.ops.control_flow": (
        "_foreach",),
    "mxnet_tpu.ops.linalg": (
        "_linalg_gelqf", "_linalg_gemm", "_linalg_gemm2", "_linalg_potrf",
        "_linalg_potri", "_linalg_sumlogdiag", "_linalg_syevd",
        "_linalg_syrk", "_linalg_trmm", "_linalg_trsm", "linalg_gelqf",
        "linalg_gemm", "linalg_gemm2", "linalg_potrf", "linalg_potri",
        "linalg_sumlogdiag", "linalg_syevd", "linalg_syrk", "linalg_trmm",
        "linalg_trsm",),
    "mxnet_tpu.ops.quantization": (
        "_contrib_dequantize", "_contrib_dequantize_v2", "_contrib_quantize",
        "_contrib_quantize_v2", "_contrib_quantized_conv",
        "_contrib_quantized_flatten", "_contrib_quantized_fully_connected",
        "_contrib_quantized_pooling", "_contrib_requantize", "_sg_int8_conv",
        "_sg_int8_elemwise_add", "_sg_int8_fully_connected",
        "_sg_int8_global_avg_pool", "_sg_int8_pooling", "dequantize",
        "quantize", "quantize_v2", "requantize",),
    "mxnet_tpu.ops.spatial": (
        "BilinearSampler", "Correlation", "GridGenerator", "SVMOutput",
        "SpatialTransformer", "bilinearsampler", "correlation",
        "gridgenerator", "spatialtransformer", "svmoutput",),
    "mxnet_tpu.ops.vision_fork": (
        "AttentionConvolution", "DynamicConvolution", "RadiateSample",),
}


def _defining_module(name):
    return ref_registry.OPS[name].fn.__module__


@pytest.mark.parametrize("module", ["mxnet_tpu.ops.init_random",
                                    "mxnet_tpu.ops.nn",
                                    "mxnet_tpu.ops.misc_parity"])
def test_every_name_of_the_module_is_ported(module):
    names = [n for n in ref_registry.list_ops()
             if _defining_module(n) == module]
    assert names
    assert [n for n in names if n not in OPS] == []


def test_only_item_9_is_missing():
    missing = {}
    for n in ref_registry.list_ops():
        if n not in OPS:
            missing.setdefault(_defining_module(n), set()).add(n)
    print("reference ops %d, port ops %d, missing %d (Queue 1 item 9)"
          % (len(ref_registry.list_ops()), len(OPS),
             sum(len(v) for v in missing.values())))
    assert missing == {k: set(v) for k, v in ITEM_9.items()}


def test_item_9_names_are_still_reference_ops():
    listed = {n for v in ITEM_9.values() for n in v}
    assert listed <= set(ref_registry.list_ops())
    assert len(listed) == 101
