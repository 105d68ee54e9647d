"""Hand-written Hopper kernels for the port, with their plain versions.

tree_aggregate — weighted child-update reduction, one launch per tree
                 level (CUDA C++, ``csrc/tree_aggregate.cu``)

``ops.py`` holds the public wrappers, ``ref.py`` the plain PyTorch
versions, ``_build.py`` the nvcc build.  A CPU tensor takes the plain
version; a CUDA tensor takes the kernel or raises.  Nothing is compiled
or loaded at import.
"""
