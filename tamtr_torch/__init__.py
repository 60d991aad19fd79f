"""TAM-TR in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `tamtr_tpu`, which stays the reference. This
package imports torch and numpy only: no JAX, no `tamtr_tpu`, no yaml, no
cv2. Its hand-written CUDA kernels (`csrc/`) build with nvcc on first use.
"""

from tamtr_torch.api import TAMTR

__all__ = ["TAMTR"]
