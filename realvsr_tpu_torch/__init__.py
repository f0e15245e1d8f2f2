"""realvsr_tpu_torch: the PyTorch / CUDA port of realvsr_tpu for NVIDIA Hopper.

Module paths mirror the JAX package's.  Public functions take channels-last
``(B, H, W, C)`` tensors as the JAX package does; entry points run on
``device="cuda"`` unless the caller asks for the CPU.  A CUDA tensor goes
through the hand-written kernels of ``ops/kernels`` (sources in ``csrc/``,
built with nvcc for sm_90a at first use); a CPU tensor through their plain
PyTorch versions.
"""
