"""PyTorch/CUDA port of halo_tpu's PLONK prover slice.

The package proves one PLONK proof end to end (circuit -> trace ->
naive_prover -> proof bytes -> verify) on tensors of canonical Montgomery
residues (R = 2^256, the same R as halo_tpu.ops.ff, so Montgomery values
match the JAX package bit for bit).  Field elements are held as 8
little-endian u32 words stored in int32, in a limb-major (8, ...) rows
layout.  Four hand-written CUDA kernels (csrc/kernels.cu) carry the hot
path on an NVIDIA Hopper card; each has a plain torch version beside it
that CPU tensors take.

The package imports torch and never jax.  From halo_tpu it reuses only the
modules whose import path is free of jax: fields, curves, poseidon, serde,
srs, native, errors, config, plonk.circuit, plonk.constants and the pure
data classes/functions of pcdl, acc, hostpoly, plonk.trace and
plonk.protocol.
"""
