"""TAM-TR in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `tamtr_tpu`, which stays the reference. This
package imports torch, numpy and scipy only: no JAX, no `tamtr_tpu`, no
yaml, no cv2. Its hand-written CUDA kernels (`csrc/`) build with nvcc on
first use.
"""

from tamtr_torch.api import NAS, RTDETR, SAM, TAMTR, YOLO, FastSAM, RTDETRWorld

__version__ = "0.1.0"
__all__ = ["TAMTR", "RTDETRWorld", "YOLO", "RTDETR", "SAM", "FastSAM", "NAS", "__version__"]
