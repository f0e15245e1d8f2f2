"""Network factory (the reference ``codes/models/VideoSR_archs.py``).

``define_g`` / ``define_d`` / ``define_f`` dispatch on the same YAML keys
and constructor options as the JAX package's
``realvsr_tpu/models/__init__.py``: every generator (EDVR_NoUp, EDVR,
TDAN, TOF, FSTRN, RCAN; ``scale`` from the top of the config), and
BasicVSR++ (``BasicVSRPlusPlus``, x4, which the JAX package lacks); every
discriminator and the VGG19 feature extractor of the perceptual loss.
Each takes ``device``, the compute ``dtype`` and the ``generator`` its
weights are drawn from.
"""
from __future__ import annotations

import torch


def define_g(opt: dict, *, device="cuda", dtype: torch.dtype = torch.float32,
             generator: torch.Generator | None = None,
             dcn_max_offset: float | None = None):
    opt_net = opt["network_G"]
    which = opt_net["which_model_G"]
    kw = dict(dcn_max_offset=dcn_max_offset, device=device, dtype=dtype,
              generator=generator)
    if which in ("EDVR", "EDVR_NoUp"):
        from realvsr_tpu_torch.models.edvr import EDVR, EDVRNoUp

        cls = EDVR if which == "EDVR" else EDVRNoUp
        return cls(
            nf=opt_net["nf"], nc=opt_net["nc"], nframes=opt_net["nframes"],
            groups=opt_net["groups"], front_RBs=opt_net["front_RBs"],
            back_RBs=opt_net["back_RBs"], center=opt_net.get("center"),
            predeblur=bool(opt_net.get("predeblur")),
            HR_in=bool(opt_net.get("HR_in")),
            w_TSA=bool(opt_net.get("w_TSA")), **kw)
    if which == "TDAN":
        from realvsr_tpu_torch.models.tdan import TDAN

        return TDAN(nf=opt_net["nf"], channel=opt_net["nc"],
                    nframes=opt_net["nframes"], nb_f=opt_net["nb_f"],
                    nb_b=opt_net["nb_b"], groups=opt_net["groups"],
                    scale=opt["scale"], **kw)
    if which == "BasicVSRPlusPlus":
        from realvsr_tpu_torch.models.basicvsr_pp import BasicVSRPlusPlus

        if opt.get("scale", 4) != 4:
            raise ValueError(f"BasicVSR++ restores x4, not x{opt['scale']}")
        return BasicVSRPlusPlus(
            mid_channels=opt_net["mid_channels"],
            num_blocks=opt_net["num_blocks"],
            max_residue_magnitude=opt_net.get("max_residue_magnitude", 10),
            is_low_res_input=opt_net.get("is_low_res_input", True), **kw)
    kw.pop("dcn_max_offset")   # the models below have no DCN
    if which == "TOF":
        from realvsr_tpu_torch.models.tof import TOF

        return TOF(nframes=opt_net["nframes"], K=opt_net["K"],
                   in_nc=opt_net["nc"], out_nc=opt_net["nc"],
                   nf=opt_net["nf"], nb=opt_net["nb"], upscale=opt["scale"],
                   **kw)
    if which == "FSTRN":
        from realvsr_tpu_torch.models.fstrn import FSTRN

        return FSTRN(k=opt_net["k"], nf=opt_net["nf"], scale=opt["scale"],
                     nframes=opt_net["nframes"], **kw)
    if which == "RCAN":
        from realvsr_tpu_torch.models.rcan import RCAN

        return RCAN(num_in_ch=opt_net["num_in_ch"],
                    num_out_ch=opt_net["num_out_ch"],
                    num_frames=opt_net["num_frames"],
                    num_feat=opt_net["num_feat"],
                    num_group=opt_net["num_group"],
                    num_block=opt_net["num_block"],
                    squeeze_factor=opt_net["squeeze_factor"],
                    upscale=opt["scale"], res_scale=opt_net["res_scale"],
                    **kw)
    raise NotImplementedError(f"Generator model [{which}] not recognized")


_MULTISCALE = {
    "MultiscaleDiscriminator_v1": "MultiscaleDiscriminatorV1",
    "MultiscaleDiscriminator_v2": "MultiscaleDiscriminatorV2",
    "MultiscaleDiscriminator_v3": "MultiscaleDiscriminatorV3",
    "MultiscaleDiscriminator_v4": "MultiscaleDiscriminatorV4",
    "LaplacePyramidDiscriminator": "LaplacePyramidDiscriminator",
    "GaussianPyramidDiscriminator": "GaussianPyramidDiscriminator",
    "ImageGradientPyramidDiscriminator_v1":
        "ImageGradientPyramidDiscriminatorV1",
    "ImageGradientPyramidDiscriminator_v2":
        "ImageGradientPyramidDiscriminatorV2",
}


def define_d(opt: dict, *, device="cuda", dtype: torch.dtype = torch.float32,
             generator: torch.Generator | None = None):
    """The discriminator of ``opt["network_D"]`` (``which_model_D``,
    ``in_nc``, ``nf``, and ``num_D`` / ``gan_type`` for the multiscale
    and pyramid ones)."""
    from realvsr_tpu_torch.models import discriminators as D
    from realvsr_tpu_torch.models import vgg

    opt_net = opt["network_D"]
    which = opt_net["which_model_D"]
    kw = dict(device=device, dtype=dtype, generator=generator)
    if which in ("discriminator_vgg_128", "discriminator_vgg_192"):
        cls = (vgg.DiscriminatorVGG128 if which.endswith("128")
               else vgg.DiscriminatorVGG192)
        return cls(in_nc=opt_net["in_nc"], nf=opt_net["nf"], **kw)
    if which in ("PatchDiscriminator", "PixelDiscriminator"):
        return getattr(D, which)(input_nc=opt_net["in_nc"],
                                 ndf=opt_net["nf"], **kw)
    if which == "UNetDiscriminator":
        return D.UNetDiscriminator(in_nc=opt_net["in_nc"], nf=opt_net["nf"],
                                   **kw)
    if which in _MULTISCALE:
        return getattr(D, _MULTISCALE[which])(
            input_nc=opt_net["in_nc"], ndf=opt_net["nf"],
            num_D=opt_net["num_D"], gan_type=opt_net["gan_type"], **kw)
    raise NotImplementedError(f"Discriminator model [{which}] not recognized")


def define_f(opt: dict | None = None, use_bn: bool = False, *,
             device="cuda", dtype: torch.dtype = torch.float32,
             generator: torch.Generator | None = None):
    """The frozen VGG19 feature extractor of the perceptual loss
    (VideoSR_archs.py:133-144): layer 34 (49 with BN)."""
    from realvsr_tpu_torch.models.vgg import VGGFeatureExtractor

    return VGGFeatureExtractor(feature_layer=49 if use_bn else 34,
                               use_bn=use_bn, use_input_norm=True,
                               device=device, dtype=dtype,
                               generator=generator)
