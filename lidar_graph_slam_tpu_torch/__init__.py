"""lidar_graph_slam_tpu_torch — the PyTorch/CUDA port of `lidar_graph_slam_tpu`.

Same sub-package layout and module names as the JAX package, which stays in the repo as
the reference every module here is tested against (`tests/test_torch_*.py`). Plain
functions on tensors; the device is the one the tensors live on. On a CUDA tensor the
hand-written kernels (`ops/kernels.py`, sources in `csrc/`) run; on a CPU tensor their
plain PyTorch versions do.

This package imports torch and never jax or flax.
"""

import torch as _torch

# The counterpart of the reference's `jax_default_matmul_precision = "highest"`
# (`lidar_graph_slam_tpu/__init__.py:9-14`): reduced-precision matmuls (TF32 here, bf16
# on the TPU) cost metres of drift in the pose chain and the 6x6 normal equations.
_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
