"""Hand-written Hopper kernels, their ctypes wrappers and plain versions."""
