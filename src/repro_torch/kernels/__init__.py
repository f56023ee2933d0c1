"""Codec kernels: plain PyTorch versions (`ref`), CUDA wrappers (`fwht`,
`quantpack`, `quantencode`, built from `repro_torch/csrc/` on first use) and
the device dispatch (`ops`); the train steps' phase marks (`marks`)."""
