"""Image IO, bitplanes, mosaics, rand48, GF(2^m), checkpoints, profiling
and roofline bounds."""
