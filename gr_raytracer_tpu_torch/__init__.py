"""PyTorch/CUDA port of gr_raytracer_tpu (general-relativistic raytracer).

The JAX package `gr_raytracer_tpu` is the reference; this package mirrors
its layout module by module. It imports torch, numpy and the standard
library only. The geodesic march runs in a hand-written CUDA kernel on the
card (csrc/kerr_rk4_march.cu) and in its plain torch version on the CPU.
"""

from gr_raytracer_tpu_torch import precision  # noqa: F401  (pins TF32 off)
