"""msf_loam_tpu_torch: the MSF-LOAM lidar-only and tightly-coupled
LiDAR-IMU frames in PyTorch, with four hand-written Hopper kernels
(``csrc/``).

Precision: importing the package turns TF32 off for CUDA matmuls and
cuDNN (``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``). The port's products (pose
transforms, Gauss-Newton normal equations) must run in full float32:
reduced-precision products flipped most nearest-neighbour picks and
diverged the solves in the JAX package's TPU runs.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
