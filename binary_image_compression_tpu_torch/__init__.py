"""PyTorch + CUDA port of binary_image_compression_tpu.

The JAX package ``binary_image_compression_tpu`` is the reference; this
package imports torch, numpy and the standard library only, never JAX or the
JAX package.  Layout mirrors the reference (``ops/ models/ parallel/
utils/``):

* ``native``              ctypes bridge to ``native/bic_native.cpp`` (record
                          packers, decide-and-pack, decoders, host encoders,
                          range and exp-Golomb coders)
* ``ops/bitpack``         packed bit rows and the GF(2) matrix algebra
                          (weights, distances, products, submatrices)
* ``ops/predict``         MED prediction on packed words, the predictor
                          matrices
* ``ops/entropy``         codelengths, the Golomb and exp-Golomb counters
* ``ops/bitstream``       bit IO, Golomb-Rice and enumerative codes,
                          ``pack_varlen``
* ``ops/search``          tile geometry and the banded distance maps
* ``ops/fused_search``    kernel K1: windowed search + serial-scan selection
* ``ops/select_windows``  kernel K4: the banded search for W > 32
* ``ops/decide``          kernel K2: two-context adaptive Golomb mode decision
* ``ops/strict``          kernel K3: the strict residual-substitution chain
* ``ops/packed_dist``     K5, K6 and the BSVD pursuit kernel
* ``ops/ransdevice``      kernel K7: codec 13's interleaved-rANS encode
* ``ops/egdevice``        kernel K8: codec 10's adaptive exp-Golomb coder
* ``ops/recpack``         kernel K9: codec 8's tile records packed into the
                          payload on the device
* ``ops/_cuda``           builds ``csrc/*.cu`` with nvcc and loads them
* ``models/codec``        BIC1/BICG/BICC containers, every codec on the host
* ``models/compress``     the device encoders: codecs 4/7/8 causal
                          (``encode``, ``encode_batch``), codec 8 strict,
                          codec 13, bitplane stacks
* ``models/archive``      BICA corpus writer with the checkpoint journal
* ``models/bsvd``         binary dictionary learning on the device
* ``models/bsvd_ref``     the reference's rand48 replay of bsvd.cpp
* ``models/ref_parity``   the reference drivers' codelength estimates
* ``parallel``            ``torch.distributed`` meshes, tile-sharded encode,
                          halo MED, bitstream merge, multi-host set-up
* ``utils``               PNM IO, bitplanes, mosaics, rand48, threefry,
                          GF(2^m), checkpoints, stage profiles and device
                          traces, roofline bounds
* ``cli``                 ``python -m binary_image_compression_tpu_torch``

Submodules are imported on demand, so importing the package is cheap.
"""

__version__ = "0.1.0"
