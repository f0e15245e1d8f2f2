"""The DCN forward kernels (``csrc/dcn_fwd.cu``, ``csrc/dcn_narrow.cu``),
through DCNPack's entry (offsets and mask logits read in place from
``om``): x, om, the weight and bias read once, the output written once;
2 x 9 x cin x cout operations a pixel on the tensor cores, and on the f32
cores 4 corners x (multiply + add) + the mask, ~9 a sampled element."""
from portbench.roofline import dtype_name, nbytes

ENTRY = ("realvsr_tpu_torch.ops.kernels.dcn", "dcn_fwd_om")
KERNELS = ("dcn_fwd_kernel", "dcn_fwd_kernel128", "fwd_kernel", "pack_fwd",
           "pack_weight_kernel")


def work(a: dict, out):
    x, w = a["x"], a["weight"]
    b, h, wd, cin = x.shape
    p, k = b * h * wd, 9 * cin
    return (nbytes(x, a["om"], w, a["bias"], out), 2 * p * k * w.shape[0],
            9 * p * k, dtype_name(x.dtype))
