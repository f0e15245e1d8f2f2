"""The 3x3 / stride 1 conv kernel (``csrc/conv3x3.cu``), through the entry
every conv of the models reaches, forward only: x (and x2, concatenated on
the channels), the weight, bias and residual read once, the output written
once; 2 x 9 x (c1 + c2) x cout operations a pixel on the tensor cores."""
from portbench.roofline import dtype_name, nbytes

ENTRY = ("realvsr_tpu_torch.ops.kernels.conv3x3", "conv3x3")
KERNELS = ("conv3x3_wgmma", "pack_weight_kernel")


def work(a: dict, out):
    x, x2, w = a["x"], a["x2"], a["weight"]
    b, h, wd, c1 = x.shape
    cin = c1 + (0 if x2 is None else x2.shape[-1])
    p = b * h * wd
    return (nbytes(x, x2, w, a["bias"], a["residual"], out),
            2 * p * 9 * cin * w.shape[0], 0, dtype_name(x.dtype))
