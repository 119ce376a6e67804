"""ResNet-50's stride-1 pointwise convolutions in plain torch float64: the
reference ``kernels.ops.scheduled_conv`` is held to.

The network is ResNet-50 v1.5, torchvision's ``resnet50`` (arXiv:1512.03385
Table 1; ``torchvision/models/resnet.py``): bottleneck blocks [3, 4, 6, 3]
of widths 64, 128, 256, 512, each a 1x1 reduce to the width, a 3x3 at the
width and a 1x1 expand to four times it, the first block of a stage with a
1x1 projection of its input; v1.5 puts a stage's stride on its first 3x3,
so that block's reduce runs at the resolution before it.  Activations are
NHWC ``[B, H, W, C]`` and a filter is ISAMIR's ``[kh, kw, Cin, Cout]``
(``core.kernels_ir.conv2d``'s ``W``).

Departures from the model, each by choice of what is measured: the
convolutions alone, with no BatchNorm, ReLU or residual add, each conv on
an input of its own; the stride-2 1x1 projections of conv3-conv5 and every
3x3 conv are left out (their extraction is not one GEMM), as are the 7x7
stem, the pooling and the fully connected layer.

``conv1x1`` computes with ``torch.nn.functional.conv2d`` on the NCHW
permutation, not as a matrix product, so that it shares nothing with the
extraction it judges.  It imports nothing but torch, and computes in
float64 with TF32 off.
"""
from __future__ import annotations

import math

import torch

#: (blocks, width, input channels, output resolution) of each stage
STAGES = ((3, 64, 64, 56), (4, 128, 256, 28), (6, 256, 512, 14),
          (3, 512, 1024, 7))
#: a bottleneck's expand: output channels = EXPANSION x width
EXPANSION = 4


def pointwise_convs() -> list[dict]:
    """The 33 stride-1 1x1 convolutions of one forward, in network order:
    each with ``stage`` (2-5, as ``conv2``-``conv5``), ``block``, ``role``
    (``reduce``, ``expand`` or ``projection``), ``h``, ``w``, ``cin`` and
    ``cout``."""
    out = []
    for s, (blocks, width, cin, res) in enumerate(STAGES):
        wide = EXPANSION * width
        for b in range(blocks):
            into = cin if b == 0 else wide
            at = res * 2 if b == 0 and s > 0 else res
            out.append(dict(stage=s + 2, block=b, role="reduce", h=at, w=at,
                            cin=into, cout=width))
            out.append(dict(stage=s + 2, block=b, role="expand", h=res,
                            w=res, cin=width, cout=wide))
            if b == 0 and s == 0:         # the one projection of stride 1
                out.append(dict(stage=s + 2, block=b, role="projection",
                                h=res, w=res, cin=cin, cout=wide))
    return out


def init_weight(cin: int, cout: int, generator: torch.Generator,
                device=None, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """A ``[1, 1, cin, cout]`` filter from ``generator``, uniform in
    ±1/sqrt(cin)."""
    u = torch.rand((1, 1, cin, cout), generator=generator, device=device,
                   dtype=dtype)
    return (2 * u - 1) / math.sqrt(cin)


def conv1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The stride-1 1x1 convolution of the NHWC activation ``x``
    ``[B, H, W, Cin]`` by the filter ``w`` ``[1, 1, Cin, Cout]``: NHWC
    ``[B, H, W, Cout]`` in float64, on ``x``'s device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    y = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                   w.to(x.device).double().permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)
