"""repro_torch — the PyTorch/CUDA port of the FedNCV reproduction.

The package mirrors `src/repro/` module for module.  Plain tensor code is
PyTorch; every Pallas kernel of the reference on the ported path is a
hand-written CUDA C++ kernel for Hopper (`sm_90a`) under
`repro_torch/kernels/*/csrc/`, built on first use and bound with `ctypes`.
Each kernel wrapper runs its plain PyTorch version for CPU tensors only.

Entry points (`fed.Simulator`) run on the CUDA device unless the caller
asks for the CPU; they never fall back to the CPU on their own.
"""
