"""Hand-written Hopper kernels (csrc/*.cu) with their plain PyTorch versions.

Importing this package builds nothing: a kernel's library is compiled by
`_build` on its first launch."""
