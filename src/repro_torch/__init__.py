"""PyTorch / CUDA port of the FLASH-D system for the NVIDIA H100.

A second package beside the JAX reference `repro`, laid out module for
module like it; it imports torch, numpy and the standard library only.

Float32 matrix products and convolutions run in full float32, as the
reference computes: TF32 is switched off here, where the port starts.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
