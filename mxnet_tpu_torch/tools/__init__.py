"""Tools of the port: :mod:`.bottleneck_probe`, the roofline probe of
ResNet-50's 1x1 convolutions with its two epilogue GEMM kernels."""
