"""primestereomatch_torch: the STEREO_GIF stereo engine on PyTorch and
hand-written CUDA kernels for an NVIDIA H100 (Hopper, sm_90a).

A port of primestereomatch_tpu, kept beside it; it imports nothing of that
package. Entry points run on the CUDA card unless the caller passes
device="cpu", which runs each kernel's plain PyTorch version.
"""

import torch

from primestereomatch_torch.config import EvalConfig, GIFConfig, from_jax_config  # noqa: F401
from primestereomatch_torch.models import StereoGIF, stereo_gif_forward  # noqa: F401

__version__ = "0.1.0"

# An argmin sits downstream of every float stage, so no stage may run in
# TF32: it keeps about three decimal digits and would move argmin ties
# (the JAX package needs HIGHEST matmul precision for the same reason).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
