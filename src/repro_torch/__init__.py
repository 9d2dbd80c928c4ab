"""PyTorch/CUDA port of the RAPID package (``repro``), for NVIDIA Hopper.

Mirrors ``src/repro``'s layout module by module and imports nothing from
it.  Plain tensor code is PyTorch; each Pallas TPU kernel on the ported
path is a hand-written CUDA C++ kernel (``csrc/``) built for ``sm_90a``
at first use and bound through ``ctypes`` (``kernels/_build.py``).
Every kernel wrapper keeps a plain PyTorch version of the same math
beside it: a CPU tensor takes the plain version, a CUDA tensor launches
the kernel or raises.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`).  Importing the package turns off
TF32 and bf16 reduced-precision reductions for every path.
"""
from repro_torch import device  # noqa: F401  (sets the exact numerics)
