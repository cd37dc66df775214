"""PyTorch/CUDA port of crossloc_tpu for NVIDIA Hopper.

Module names follow `crossloc_tpu/` so each counterpart is easy to find.
The port imports torch, numpy and the standard library only; the JAX
package stays the reference it is tested against. Entry points run on the
card unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
