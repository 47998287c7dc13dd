"""dealii_asm_tpu_torch — the PyTorch + CUDA port of ``dealii_asm_tpu``.

It runs the matrix-free high-order FEM multigrid solve with FDM Schwarz
smoothers on an NVIDIA Hopper GPU.  The layout mirrors the JAX package
module by module (``ops.laplace.LaplaceOperator`` stands for
``dealii_asm_tpu.ops.laplace.LaplaceOperator``, and so on).  Hot paths run
hand-written CUDA kernels (``kernels/``); every kernel has a plain PyTorch
version beside it, which runs on CPU tensors.  The package imports torch,
NumPy and SciPy, plus the JAX package's jax-free host layer (meshes, DoF
lattices, 1D Lagrange elements, config helpers) — never jax.
"""

__version__ = "0.1.0"
