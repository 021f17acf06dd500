"""The paper's own benchmark CNNs (Tables I/II): LeNet-5, VGG-16, ResNet-18.

Copied field for field from the JAX package's ``configs/paper_cnns.py``:
they drive the FORMS pipeline (accuracy and crossbar reduction) on the
synthetic image stream.  Conv shapes are (kh, kw, cin, cout).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    image_size: int
    in_channels: int
    num_classes: int
    # list of ("conv", cout, kernel, stride) | ("res", cout, stride) |
    # ("pool",) | ("fc", out)
    arch: Tuple[Tuple, ...]


LENET5 = CNNConfig(
    name="lenet5", image_size=28, in_channels=1, num_classes=10,
    arch=(("conv", 6, 5, 1), ("pool",), ("conv", 16, 5, 1), ("pool",),
          ("fc", 120), ("fc", 84), ("fc", 10)),
)

# VGG-16-style for 32x32 inputs (CIFAR): conv stacks + pools + classifier
VGG16 = CNNConfig(
    name="vgg16", image_size=32, in_channels=3, num_classes=10,
    arch=(("conv", 64, 3, 1), ("conv", 64, 3, 1), ("pool",),
          ("conv", 128, 3, 1), ("conv", 128, 3, 1), ("pool",),
          ("conv", 256, 3, 1), ("conv", 256, 3, 1), ("conv", 256, 3, 1), ("pool",),
          ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("pool",),
          ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("pool",),
          ("fc", 512), ("fc", 10)),
)

RESNET18 = CNNConfig(
    name="resnet18", image_size=32, in_channels=3, num_classes=10,
    arch=(("conv", 64, 3, 1),
          ("res", 64, 1), ("res", 64, 1),
          ("res", 128, 2), ("res", 128, 1),
          ("res", 256, 2), ("res", 256, 1),
          ("res", 512, 2), ("res", 512, 1),
          ("fc", 10)),
)

def tiny_cnn(name: str = "tiny-lenet") -> CNNConfig:
    """A LeNet-family CNN small enough for CPU ADMM training in benchmarks."""
    return CNNConfig(
        name=name, image_size=16, in_channels=1, num_classes=10,
        arch=(("conv", 8, 3, 1), ("pool",), ("conv", 16, 3, 1), ("pool",),
              ("fc", 64), ("fc", 10)),
    )
