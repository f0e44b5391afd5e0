"""flame_ros_torch — FLaME dense monocular depth estimation in PyTorch/CUDA.

The PyTorch port of `flame_ros_tpu` (the JAX package, which stays the
reference). Module names mirror the JAX package's so each module's
counterpart is easy to find. Numeric state lives in torch tensors on an
explicit device; the triangle rasterizer runs as hand-written CUDA
kernels (`csrc/raster.cu`) on the card and as its plain PyTorch version
on the CPU.

Importing the package turns TF32 off for matmul and cuDNN: the reference
pins geometry contractions to full f32 (docs/ARCHITECTURE.md, "Numerics
policy").
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from flame_ros_torch.config import FlameParams  # noqa: E402
from flame_ros_torch.geometry.se3 import SE3  # noqa: E402
from flame_ros_torch.geometry.camera import Pinhole  # noqa: E402

__version__ = "0.1.0"
__all__ = ["FlameParams", "SE3", "Pinhole", "__version__"]
