"""The paper's core algorithms (only the Hadamard frame is ported so far)."""
