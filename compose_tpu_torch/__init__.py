"""compose_tpu_torch: the PyTorch + CUDA port of compose_tpu.

The same semi-Lagrangian tracer-transport core, written for one NVIDIA
Hopper GPU: plain tensor code is PyTorch, and the property-preservation
and DSS kernels of the ISL step are hand-written CUDA C++
(``compose_tpu_torch/csrc``), built with nvcc at first use. Module paths and
public names mirror ``compose_tpu`` so each counterpart is easy to find.

Every entry point takes an explicit ``device``; CPU tensors take each
kernel's plain PyTorch version, CUDA tensors launch the kernel.
"""

__version__ = "0.1.0"
