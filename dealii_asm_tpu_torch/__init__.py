"""dealii_asm_tpu_torch — the PyTorch + CUDA port of ``dealii_asm_tpu``.

It runs the matrix-free high-order FEM multigrid solve with FDM Schwarz
smoothers on an NVIDIA Hopper GPU.  The layout mirrors the JAX package
module by module (``ops.laplace.LaplaceOperator`` stands for
``dealii_asm_tpu.ops.laplace.LaplaceOperator``, and so on).  Hot paths run
hand-written CUDA kernels (``kernels/``); every kernel has a plain PyTorch
version beside it, which runs on CPU tensors.  The package imports torch,
NumPy and SciPy, and carries its own copy of the NumPy host layer it needs
(meshes and their transforms, DoF lattices, 1D Lagrange elements, FDM 1D
setup, config helpers): never jax, nor any module of the JAX package.
"""

__version__ = "0.1.0"
