"""Block-ELL Chebyshev kernels of the port (mirrors ``repro/kernels``):
plain versions in ``ref``, CUDA C++ in ``csrc/cheb_bsr.cu`` behind the
wrappers in ``cheb_bsr``, tiling in ``autotune``, and the apply chains in
``ops``. Importing this package builds nothing."""
