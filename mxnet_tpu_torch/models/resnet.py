"""Symbolic pre-activation ResNet (counterpart of
``example/image-classification/symbols/resnet.py``), written with the port's
symbol API: the same arguments give the same argument names, auxiliary
states and shapes."""
from .. import symbol as sym

__all__ = ["residual_unit", "get_symbol"]


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True):
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu")
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4,
                                kernel=(1, 1), no_bias=True,
                                name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu")
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu")
        out = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                              no_bias=True, name=name + "_conv3")
    else:
        bn1 = sym.BatchNorm(data, fix_gamma=False, name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu")
        conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                                stride=stride, pad=(1, 1), no_bias=True,
                                name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu")
        out = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                              pad=(1, 1), no_bias=True, name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride,
                                   no_bias=True, name=name + "_sc")
    return out + shortcut


def get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224"):
    """ResNet v1 (pre-act) for ImageNet-scale inputs."""
    configs = {18: ([2, 2, 2, 2], [64, 64, 128, 256, 512], False),
               34: ([3, 4, 6, 3], [64, 64, 128, 256, 512], False),
               50: ([3, 4, 6, 3], [64, 256, 512, 1024, 2048], True),
               101: ([3, 4, 23, 3], [64, 256, 512, 1024, 2048], True),
               152: ([3, 8, 36, 3], [64, 256, 512, 1024, 2048], True)}
    if num_layers not in configs:
        raise ValueError("unsupported num_layers %d" % num_layers)
    units, filters, bottle_neck = configs[num_layers]
    data = sym.var("data")
    body = sym.Convolution(data, num_filter=filters[0], kernel=(7, 7),
                           stride=(2, 2), pad=(3, 3), no_bias=True,
                           name="conv0")
    body = sym.BatchNorm(body, fix_gamma=False, name="bn0")
    body = sym.Activation(body, act_type="relu")
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    for i, n in enumerate(units):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filters[i + 1], stride, False,
                             "stage%d_unit1" % (i + 1), bottle_neck)
        for j in range(n - 1):
            body = residual_unit(body, filters[i + 1], (1, 1), True,
                                 "stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck)
    bn = sym.BatchNorm(body, fix_gamma=False, name="bn1")
    act = sym.Activation(bn, act_type="relu")
    pool = sym.Pooling(act, global_pool=True, kernel=(7, 7), pool_type="avg")
    flat = sym.Flatten(pool)
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, sym.var("softmax_label"), name="softmax")
