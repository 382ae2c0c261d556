"""Precision pins and device selection.

Every contraction in the renderer is 4-dimensional frame math. In the JAX
package, default-precision f32 contractions on the TPU ran with bf16 passes
and broke the Kerr camera tetrad (<e0,e0> = -1.0139 instead of -1), so it
pins HIGHEST precision (gr_raytracer_tpu/precision.py). The counterpart on
the card is TF32, which keeps about three decimal digits: it is switched off
for matrix products and convolutions alike.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. A missing card raises instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is false; "
            "pass --device cpu (device='cpu') to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device
