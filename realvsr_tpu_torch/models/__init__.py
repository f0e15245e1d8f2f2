"""Network factory (the reference ``codes/models/VideoSR_archs.py``).

``define_g(opt)`` dispatches on the same YAML keys as the JAX package's
``realvsr_tpu/models/__init__.py``.  Only EDVR_NoUp is ported so far.
"""
from __future__ import annotations

import torch


def define_g(opt: dict, *, device="cuda", dtype: torch.dtype = torch.float32,
             generator: torch.Generator | None = None,
             dcn_max_offset: float | None = None):
    opt_net = opt["network_G"]
    which = opt_net["which_model_G"]
    if which == "EDVR_NoUp":
        from realvsr_tpu_torch.models.edvr import EDVRNoUp

        return EDVRNoUp(
            nf=opt_net["nf"], nc=opt_net["nc"], nframes=opt_net["nframes"],
            groups=opt_net["groups"], front_RBs=opt_net["front_RBs"],
            back_RBs=opt_net["back_RBs"], center=opt_net["center"],
            predeblur=bool(opt_net["predeblur"]), HR_in=bool(opt_net["HR_in"]),
            w_TSA=bool(opt_net["w_TSA"]), dcn_max_offset=dcn_max_offset,
            device=device, dtype=dtype, generator=generator)
    if which in ("EDVR", "TDAN", "TOF", "FSTRN", "RCAN"):
        raise NotImplementedError(
            f"Generator [{which}] is not ported yet (ROADMAP, queue 1, "
            f"item {3 if which == 'EDVR' else 8})")
    raise NotImplementedError(f"Generator model [{which}] not recognized")
