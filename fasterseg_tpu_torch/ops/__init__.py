from .conv import BatchNorm, Conv, ConvBnRelu, ConvNorm, conv_padding, fold_bn
from .primitives import OP_CLASSES, make_op
from .resize import downsample_half, resize_bilinear, scale_by
from .seg_heads import FeatureFusion, Head
