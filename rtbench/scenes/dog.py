"""dm_control's dog through the port's API: `models.dog.build` at the
configuration's resolution, bounce depth and samples, lit where the traffic
asks.  The file the port reads has to be the configuration's (its digest),
and the model's own assumptions (the matte alpha, the light's jitter cube)
the configuration's too."""

import hashlib

import numpy as np

F32 = np.float32


def build(cfg: dict, spp: int, lit: bool):
    from rust_raytrace_tpu_torch.models import dog

    with open(dog.DATA_PATH, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != cfg["data_sha256"]:
        raise ValueError(f"{dog.DATA_PATH}: sha256 {digest}, the "
                         f"configuration states {cfg['data_sha256']}")
    scene, view = dog.build(resolution=tuple(cfg["resolution"]),
                            maxdepth=cfg["maxdepth"], samples=spp,
                            with_light=lit)
    if dog.MATTE_ALPHA != cfg["matte_alpha"] or (
            lit and F32(scene.lights.len2) != F32(cfg["light_len2"])):
        raise ValueError("models.dog's matte alpha or light differs from "
                         "the configuration's")
    return scene, view
