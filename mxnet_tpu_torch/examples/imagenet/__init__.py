"""ImageNet-scale training, the port's counterpart of ``examples/imagenet/``."""
