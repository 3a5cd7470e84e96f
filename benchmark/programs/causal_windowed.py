"""Codecs 4, 7 and 8 in causal mode, as the port's CLI runs them: a PBM
page through ``compress.encode`` (``compress``), a corpus through
``archive.encode_archive`` with the checkpoint journal (``archive``)."""

from binary_image_compression_tpu_torch.models import archive, codec, compress


def params(config: dict) -> codec.CodecParams:
    return codec.CodecParams(codec=config["codec"], W=config["W"],
                             T=config["T"], R=config["R"], strict=False)


def page_entry(config: dict, device, profile):
    """img -> stream, with the program's stage timers in `profile`."""
    p = params(config)
    return lambda img: compress.encode(img, p, device=device,
                                       profile=profile)


def archive_entry(config: dict, device):
    """(pages, journal path, on_progress) -> BICA archive."""
    p, bs = params(config), config["archive_batch_size"]

    def run(pages, checkpoint, on_progress):
        return archive.encode_archive(pages, p, batch_size=bs, device=device,
                                      checkpoint=checkpoint,
                                      on_progress=on_progress)
    return run
