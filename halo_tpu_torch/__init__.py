"""PyTorch/CUDA port of halo_tpu: a Halo-style recursive prover over the
Pasta cycle, for one NVIDIA Hopper card.

The package proves PLONK proofs end to end (circuit -> trace ->
naive_prover -> proof bytes -> verify), reads proofs back from bytes,
runs the IVC chain of frontend/ivc.py (IVCState.init -> prove -> verify)
and signs and verifies batches of Schnorr signatures (schnorr.sign_batch,
verify_batch); parallel/ runs the NTTs and commitments of a proof over a
mesh of devices and an IVC step's two provers at once (one process), on
tensors of
canonical Montgomery residues (R = 2^256, the same R as halo_tpu.ops.ff, so
Montgomery values match the JAX package bit for bit).  Field elements are
held as 8 little-endian u32 words stored in int32, in a limb-major (8, ...)
rows layout.  Ten hand-written CUDA kernels (csrc/kernels.cu) carry the
device work on an NVIDIA Hopper card; each has a plain torch version
beside it that CPU tensors take.

The package imports torch, never jax and nothing of halo_tpu: the host
pieces it shares with the JAX package (fields, curves, Poseidon, the
arithmetizer, the proof data classes, the succinct verifiers, the
frontend) are its own copies, under the same module names.
"""
