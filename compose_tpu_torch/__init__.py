"""compose_tpu_torch: the PyTorch + CUDA port of compose_tpu.

The same semi-Lagrangian tracer-transport core, written for one NVIDIA
Hopper GPU: plain tensor code is PyTorch, and the property-preservation
and DSS kernels of the ISL step are hand-written CUDA C++
(``compose_tpu_torch/csrc``), built with nvcc at first use. Module paths and
public names mirror ``compose_tpu`` so each counterpart is easy to find.

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; CPU tensors take each kernel's plain PyTorch version,
CUDA tensors launch the kernel of their dtype (f64, or f32 on the
single-precision route ``driver.run(x64=False)``).
"""

__version__ = "0.1.0"
