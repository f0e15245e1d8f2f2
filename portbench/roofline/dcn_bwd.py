"""The DCN backward kernels (``csrc/dcn_bwd.cu``, ``csrc/dcn_narrow.cu``)
through DCNPack's entry: x, om, the weight and the output's gradient read
once, dx, dom and dweight written once; the tensor cores' dS = g W^T and
dW = g^T S, 2 x 2 x 9 x cin x cout operations a pixel, and on the f32 cores
one sampling with its four corners' gradients, ~20 a sampled element."""
from portbench.roofline import dtype_name, nbytes

ENTRY = ("realvsr_tpu_torch.ops.kernels.dcn", "dcn_bwd_om")
KERNELS = ("dcn_bwd_kernel64", "dcn_bwd_kernel128", "prep_weight_kernel",
           "bwd_kernel", "pack_bwd")


def work(a: dict, out):
    x, w = a["x"], a["weight"]
    b, h, wd, cin = x.shape
    p, k = b * h * wd, 9 * cin
    return (nbytes(x, a["om"], w, a["g"], *out), 4 * p * k * w.shape[0],
            20 * p * k, dtype_name(x.dtype))
