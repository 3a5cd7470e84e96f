"""Containers and codecs, the device encoders, the BICA archive, BSVD
learning and the reference replays."""
