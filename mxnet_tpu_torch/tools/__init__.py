"""Tools of the port: :mod:`.bottleneck_probe`, the roofline probe of
ResNet-50's 1x1 convolutions with its two epilogue GEMM kernels, and
:mod:`.flash_bwd_ab`, the flash backward pair of this checkout against
another's on one card."""
