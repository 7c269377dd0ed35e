"""PLONK protocol shape constants (reference crates/plonk/src/utils.rs:14-25)."""

T_POLYS = 16  # quotient chunks
W_POLYS = 16  # witness columns
R_POLYS = 15  # round-constant columns
Q_POLYS = 10  # selector columns [l, r, o, m, c, poseidon, aff+, aff*, eq, range]
S_POLYS = 8  # permutation columns
CONSTRAINT_DEGREE_MULTIPLIER = 8  # extended domain = 8n
