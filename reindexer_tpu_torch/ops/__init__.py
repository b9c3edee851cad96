"""Scans and kernels of reindexer_tpu_torch."""
import torch

# every product that feeds an exact top-k, the plain versions' matmuls
# included, must be fp32-accurate: TF32 keeps about three decimal digits and
# reorders near-tied candidates
torch.backends.cuda.matmul.allow_tf32 = False
