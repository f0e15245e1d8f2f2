"""Least times of kernel calls from the data-sheet peaks of one H100 SXM.

A call's least time is the larger of its bytes over the memory bandwidth
and its operations over the peak of the units that do them (the tensor
cores at the call's precision, and the float32 cores for the elementwise
work beside them; the two run at once, so the slower counts).  Bytes count
each input read once and each output written once, whatever the kernel
reads again.  A frozen copy of the arithmetic beside ``chip_smoke.py``'s
kernel timings.
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12                       # HBM3, data sheet
PEAK_TC_FLOPS = {"bfloat16": 989e12,          # dense bf16
                 "float32": 495e12}           # TF32: f32 on the tensor cores
PEAK_F32_FLOPS = 67e12                        # f32 outside the tensor cores


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def least_s(bytes_moved: int, tc_flops: int, f32_flops: int,
            dtype: str) -> float:
    return max(bytes_moved / PEAK_BYTES_S,
               tc_flops / PEAK_TC_FLOPS[dtype], f32_flops / PEAK_F32_FLOPS)


def share(readings, families) -> float | None:
    """100 x the least time of every call of ``families`` in the traced
    window over the device time of the ops those calls launched; None
    where the window made no such call."""
    work = [w for fam in families for w in readings.calls.get(fam, ())]
    if not work or readings.timeline is None:
        return None
    secs, _ = readings.timeline.family_device_s(readings.kernels)
    device = sum(secs.get(fam, 0.0) for fam in families)
    if device <= 0:
        return None
    return 100.0 * sum(least_s(*w) for w in work) / device
