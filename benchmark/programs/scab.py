"""Codec 13 as the port's CLI runs it for a PBM page, ``compress --codec
13 --entropy <entropy>``: ``compress.encode_scab``."""

from binary_image_compression_tpu_torch.models import codec, compress


def page_entry(config: dict, device, profile):
    """img -> stream (the program keeps no stage timers on this path)."""
    p = codec.CodecParams(codec=13, W=config["W"], T=config["T"],
                          R=config["R"], strict=False)
    return lambda img: compress.encode_scab(
        img, p, entropy=config["entropy"], device=device)
