"""Network factory (the reference ``codes/models/VideoSR_archs.py``).

``define_g(opt)`` dispatches on the same YAML keys as the JAX package's
``realvsr_tpu/models/__init__.py``: EDVR_NoUp, EDVR (x4) and TDAN (with
``scale`` from the top of the config) are ported; TOF, FSTRN and RCAN are
not yet.
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
    if which in ("TOF", "FSTRN", "RCAN"):
        raise NotImplementedError(
            f"Generator [{which}] is not ported yet (ROADMAP, queue 1, "
            "item 5)")
    raise NotImplementedError(f"Generator model [{which}] not recognized")
