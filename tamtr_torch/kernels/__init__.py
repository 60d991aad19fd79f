"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Importing the package registers the torch ops `tamtr::ss2d_scan_fwd` (B1)
and `tamtr::bilinear_gather_fwd` (B2), which a program exported by
`torch.export` calls; it builds nothing."""

import torch


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """x for fp32 maths: bf16 cast up to fp32, fp32 and fp64 as they are
    (flax promotes against fp32 parameters the same way). The plain
    versions of the kernels and the model's fp32 islands use it, so a bf16
    input computes in fp32 and an fp64 parity run stays fp64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


from tamtr_torch.kernels import deform_scatter, selective_scan  # noqa: E402,F401  (registers the tamtr:: ops)
