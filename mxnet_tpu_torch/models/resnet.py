"""ResNet v2 (pre-activation): the symbol the bench trains (the JAX
package's ``models/resnet.py``).

:func:`residual_unit`, :func:`resnet` and :func:`get_symbol` compose the
same graph as the JAX package, node for node and name for name: both stems
(``conv7``, and ``s2d``, the space-to-depth stem of NHWC graphs: a
``reshape`` with ``0`` codes, a ``transpose``, a ``Pad`` and a 4x4 conv),
both layouts and every depth of the unit table.  ``dtype="bfloat16"``
casts the input once and the logits back to fp32; the parameters and
BatchNorm's moving statistics stay fp32.  ``layout="NHWC"`` transposes the
NCHW input once at the stem.

``convert_stem_to_s2d`` (which maps a conv7 checkpoint's NDArrays onto the
s2d stem) waits for the port's NDArray.
"""

from .. import symbol as sym

__all__ = ["get_symbol", "resnet", "residual_unit"]

BN_MOM = 0.9
BN_EPS = 2e-5


def _layer_fns(layout, bn_mom):
    """conv/bn/pool closures for the chosen layout."""
    bn_axis = 3 if layout == "NHWC" else 1

    def conv(**kw):
        return sym.Convolution(layout=layout, **kw)

    def bn(**kw):
        return sym.BatchNorm(axis=bn_axis, momentum=bn_mom, eps=BN_EPS, **kw)

    def pool(**kw):
        return sym.Pooling(layout=layout, **kw)

    return conv, bn, pool


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True,
                  num_group=1, bn_mom=BN_MOM, layout="NCHW"):
    """Pre-activation residual unit (v2)."""
    conv, bn, _ = _layer_fns(layout, bn_mom)
    if bottle_neck:
        # resnext (grouped) bottlenecks are twice as wide: 0.5x vs 0.25x
        # (reference resnext.py int(num_filter*0.5) vs resnet.py 0.25)
        width = num_filter // 2 if num_group > 1 else num_filter // 4
        bn1 = bn(data=data, fix_gamma=False, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv1 = conv(data=act1, num_filter=width,
                     kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                     no_bias=True, name=name + "_conv1")
        bn2 = bn(data=conv1, fix_gamma=False, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv2 = conv(data=act2, num_filter=width,
                     num_group=num_group, kernel=(3, 3),
                     stride=stride, pad=(1, 1), no_bias=True,
                     name=name + "_conv2")
        bn3 = bn(data=conv2, fix_gamma=False, name=name + "_bn3")
        act3 = sym.Activation(data=bn3, act_type="relu", name=name + "_relu3")
        conv3 = conv(data=act3, num_filter=num_filter, kernel=(1, 1),
                     stride=(1, 1), pad=(0, 0), no_bias=True,
                     name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = conv(data=act1, num_filter=num_filter,
                            kernel=(1, 1), stride=stride,
                            no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    else:
        bn1 = bn(data=data, fix_gamma=False, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv1 = conv(data=act1, num_filter=num_filter, kernel=(3, 3),
                     stride=stride, pad=(1, 1), no_bias=True,
                     name=name + "_conv1")
        bn2 = bn(data=conv1, fix_gamma=False, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv2 = conv(data=act2, num_filter=num_filter, kernel=(3, 3),
                     stride=(1, 1), pad=(1, 1), no_bias=True,
                     name=name + "_conv2")
        if dim_match:
            shortcut = data
        else:
            shortcut = conv(data=act1, num_filter=num_filter,
                            kernel=(1, 1), stride=stride,
                            no_bias=True, name=name + "_sc")
        return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, num_group=1, bn_mom=BN_MOM, dtype="float32",
           layout="NCHW", stem="conv7"):
    """The network: stem, ``num_stages`` stages of ``units[i]`` residual
    units of width ``filter_list[i + 1]``, BatchNorm, ReLU, global average
    pool, ``fc1`` and a ``SoftmaxOutput`` named ``softmax``."""
    conv, bn, pool = _layer_fns(layout, bn_mom)
    data = sym.Variable("data")
    if dtype != "float32":
        data = sym.Cast(data=data, dtype=dtype)
    if layout == "NHWC":
        # one transpose at the stem; everything downstream is channels-last
        data = sym.transpose(data, axes=(0, 2, 3, 1), name="to_nhwc")
    (nchannel, height, width) = image_shape
    data = bn(data=data, fix_gamma=True, name="bn_data")
    if stem not in ("conv7", "s2d"):
        raise ValueError("unknown stem %r (valid: 'conv7', 's2d')" % (stem,))
    if height <= 32:  # cifar-style stem (3x3/s1: nothing for s2d to fold)
        if stem != "conv7":
            raise ValueError("stem=%r is not applicable to the cifar-style "
                             "3x3 stem (height <= 32)" % (stem,))
        body = conv(data=data, num_filter=filter_list[0],
                    kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    no_bias=True, name="conv0")
    else:
        if stem == "s2d":
            # space-to-depth stem (the MLPerf ResNet trick, NHWC-only):
            # the 7x7/s2 conv is EXACTLY a 4x4/s1 conv on 2x2-blocked
            # input with the kernel zero-padded to 8x8 (12 input channels
            # instead of 3)
            if layout != "NHWC":
                raise ValueError("stem='s2d' requires layout='NHWC'")
            if height % 2 or width % 2:
                raise ValueError("stem='s2d' requires even image dims, "
                                 "got %dx%d" % (height, width))
            # 0 = copy the batch dim: binding a different spatial size then
            # fails the element-count check instead of silently reslicing
            # the batch into garbage samples
            d = sym.reshape(data, shape=(0, height // 2, 2, width // 2, 2,
                                         nchannel))
            d = sym.transpose(d, axes=(0, 1, 3, 2, 4, 5))
            d = sym.reshape(d, shape=(0, height // 2, width // 2,
                                      4 * nchannel), name="s2d")
            # conv taps cover block offsets -2..1 (the 8x8 kernel's front
            # zero-row shifts the grid): asymmetric pad (2,1)
            d = sym.Pad(d, mode="constant",
                        pad_width=(0, 0, 2, 1, 2, 1, 0, 0))
            body = conv(data=d, num_filter=filter_list[0], kernel=(4, 4),
                        stride=(1, 1), pad=(0, 0), no_bias=True,
                        name="conv0")
        else:  # imagenet conv7 stem
            body = conv(data=data, num_filter=filter_list[0],
                        kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                        no_bias=True, name="conv0")
        body = bn(data=body, fix_gamma=False, name="bn0")
        body = sym.Activation(data=body, act_type="relu", name="relu0")
        body = pool(data=body, kernel=(3, 3), stride=(2, 2),
                    pad=(1, 1), pool_type="max")

    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             name="stage%d_unit%d" % (i + 1, 1),
                             bottle_neck=bottle_neck, num_group=num_group,
                             bn_mom=bn_mom, layout=layout)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name="stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck=bottle_neck, num_group=num_group,
                                 bn_mom=bn_mom, layout=layout)
    bn1 = bn(data=body, fix_gamma=False, name="bn1")
    relu1 = sym.Activation(data=bn1, act_type="relu", name="relu1")
    pool1 = pool(data=relu1, global_pool=True, kernel=(7, 7),
                 pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    if dtype != "float32":
        fc1 = sym.Cast(data=fc1, dtype="float32")
    return sym.SoftmaxOutput(data=fc1, name="softmax")


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               num_group=1, dtype="float32", layout="NCHW", **kwargs):
    """ResNet of ``num_layers`` (the reference's unit table) for
    ``image_shape`` ``(C, H, W)`` inputs; ``stem=`` by keyword."""
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    height = image_shape[1]
    if height <= 28:  # mnist/cifar-small
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError("no experiments done on num_layers %d" % num_layers)
        units = per_unit * num_stages
    else:
        num_stages = 4
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        units_table = {
            18: [2, 2, 2, 2],
            34: [3, 4, 6, 3],
            50: [3, 4, 6, 3],
            101: [3, 4, 23, 3],
            152: [3, 8, 36, 3],
            200: [3, 24, 36, 3],
            269: [3, 30, 48, 8],
        }
        if num_layers not in units_table:
            raise ValueError("no experiments done on num_layers %d" % num_layers)
        units = units_table[num_layers]

    return resnet(units=units, num_stages=num_stages, filter_list=filter_list,
                  num_classes=num_classes, image_shape=image_shape,
                  bottle_neck=bottle_neck, num_group=num_group, dtype=dtype,
                  layout=layout, stem=kwargs.get("stem", "conv7"))
