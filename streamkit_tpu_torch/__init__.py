# SPDX-License-Identifier: Apache-2.0
"""streamkit_tpu_torch — the PyTorch/CUDA port of streamkit_tpu.

Runs the system's paths on an NVIDIA H100 with PyTorch for the plain tensor
code and hand-written Hopper kernels (``csrc/``) where the JAX package has
Pallas kernels. It imports neither JAX nor the JAX package; entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
