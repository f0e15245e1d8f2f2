"""The block DCN API: DCNv2 with offsets clamped to ±R (kernel 5 of the TPU
table).

Counterpart of ``realvsr_tpu/ops/deform_conv_block.py::
modulated_deform_conv_block`` with ``use_pallas=True``, which runs the TPU
kernel ``realvsr_tpu/ops/pallas/dcn_block_kernel.py::dcn_block_fused``: the
±R-clamped DCNv2 forward, 3x3 / stride 1 / pad 1, zero padding outside the
image, bias added after the product.  Within the clamp it is the exact op.

The TPU kernel reads XLA-extracted halo patches (n, dg, PH*cpg, PW) and an
f32 (ly, lx, mask) coordinate tensor, and builds the bilinear weights as
interpolation matrices for its matrix unit; that geometry (``block``,
``chunk_blocks``, ``frame_fold``, ``frame_gemm``) exists only for Mosaic
(``dcn_block_kernel.py:1-35``) and is not carried here, nor is
``use_pallas``.  On the H100 the clamped forward is the function of the
hand-written DCN forward ``csrc/dcn_fwd.cu`` (kernel 1's counterpart) with
``max_offset=R``, which samples in place from NHWC with exact f32 positions:
a CUDA tensor launches it, counted in ``modulated_deform_conv_block.
launches``; a CPU tensor runs :func:`~realvsr_tpu_torch.ops.deform_conv.
modulated_deform_conv_plain` with ``max_offset=R``.  In f32 both compute
the same function as ``dcn_block_fused`` (``tests/test_deform_conv.py``
holds that kernel to the exact XLA block path at 5e-6).

Known difference: in bf16 the TPU kernel rounds its interpolation weights
and its horizontal pass to bf16 (``dcn_block_kernel.py:57-68``) and adds
the bias after the cast to bf16; the port interpolates in f32 and rounds
the sampled columns once, so bf16 results agree within the DCN tolerance of
``ops/kernels/check.py``, not bit for bit.
"""
from __future__ import annotations

import torch

from realvsr_tpu_torch.ops.deform_conv import modulated_deform_conv_plain
from realvsr_tpu_torch.ops.kernels.dcn import launch_fwd


def modulated_deform_conv_block(x: torch.Tensor, offset: torch.Tensor,
                                mask: torch.Tensor | None,
                                weight: torch.Tensor,
                                bias: torch.Tensor | None = None,
                                padding: int = 1, deformable_groups: int = 8,
                                max_offset: int = 8) -> torch.Tensor:
    """DCNv2 forward with the offsets clamped to [-int(R), int(R)], NHWC.

    x: (B, H, W, C); offset: (B, H, W, dg*9*2) laid out (dg, tap, (dy,
    dx)); mask: (B, H, W, dg*9) after the sigmoid, or None for ones; weight
    (cout, C, 3, 3) (OIHW; the kernel takes cout = 64); bias (cout,) or
    None.  Forward only.
    """
    if tuple(weight.shape[2:]) != (3, 3) or padding != 1:
        raise ValueError("block path: 3x3/s1/p1 only")
    r = int(max_offset)
    dg = deformable_groups
    if x.device.type == "cpu":
        return modulated_deform_conv_plain(x, offset, mask, weight, bias, 1,
                                           1, 1, dg, r)
    if mask is None:
        mask = torch.ones(*x.shape[:3], dg * 9, device=x.device,
                          dtype=x.dtype)
    out = launch_fwd(x, offset, mask, weight, bias, dg, None, r)
    modulated_deform_conv_block.launches += 1
    return out


modulated_deform_conv_block.launches = 0
