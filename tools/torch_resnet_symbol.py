"""A ResNet V1 bottleneck network written with `mx.sym` operators, for
either package (pass the package as `mx`): the symbolic model the Module
API trains in tests/test_torch_module.py and in chip_smoke.py's
`module_small` phase.

Each bottleneck unit is conv1x1 -> BN -> relu -> conv3x3 -> BN -> relu
-> conv1x1 -> BN, plus a projection shortcut (conv1x1 -> BN) where the
shape changes, then relu of the sum: in NHWC every 1x1 convolution
meets a training BatchNorm, the pair the port's graph runs on the
`conv1x1_bn_stats` kernel.
"""
from __future__ import annotations

__all__ = ["resnet_v1_symbol"]


def _conv_bn(mx, x, name, channels, kernel, stride, layout, axis, act):
    pad = (kernel // 2, kernel // 2)
    x = mx.sym.Convolution(x, num_filter=channels, kernel=(kernel, kernel),
                           stride=(stride, stride), pad=pad, no_bias=True,
                           layout=layout, name=name + "_conv")
    x = mx.sym.BatchNorm(x, axis=axis, fix_gamma=False, eps=1e-5,
                         momentum=0.9, name=name + "_bn")
    return mx.sym.Activation(x, act_type="relu", name=name + "_relu") \
        if act else x


def resnet_v1_symbol(mx, units=(3, 4, 6, 3), filters=(64, 256, 512, 1024,
                                                       2048),
                     num_classes=1000, layout="NHWC", thumbnail=True):
    """The symbol, ending in ``SoftmaxOutput(name="softmax")``.
    `filters[0]` is the stem's width, `filters[i + 1]` stage i's output;
    a `thumbnail` stem is one 3x3 convolution (small images)."""
    axis = 3 if layout == "NHWC" else 1
    data = mx.sym.var("data")
    if thumbnail:
        x = _conv_bn(mx, data, "stem", filters[0], 3, 1, layout, axis, True)
    else:
        x = _conv_bn(mx, data, "stem", filters[0], 7, 2, layout, axis, True)
        x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max", layout=layout, name="stem_pool")
    in_ch = filters[0]
    for i, n in enumerate(units):
        out_ch = filters[i + 1]
        for j in range(n):
            name = "stage%d_unit%d" % (i + 1, j + 1)
            stride = 2 if i > 0 and j == 0 else 1
            body = _conv_bn(mx, x, name + "_a", out_ch // 4, 1, stride,
                            layout, axis, True)
            body = _conv_bn(mx, body, name + "_b", out_ch // 4, 3, 1, layout,
                            axis, True)
            body = _conv_bn(mx, body, name + "_c", out_ch, 1, 1, layout,
                            axis, False)
            short = x
            if stride != 1 or in_ch != out_ch:
                short = _conv_bn(mx, x, name + "_sc", out_ch, 1, stride,
                                 layout, axis, False)
            x = mx.sym.Activation(body + short, act_type="relu",
                                  name=name + "_out")
            in_ch = out_ch
    x = mx.sym.Pooling(x, kernel=(1, 1), global_pool=True, pool_type="avg",
                       layout=layout, name="pool")
    x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=num_classes,
                              name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")
