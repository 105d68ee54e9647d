"""Hand-written Hopper kernels for the port, with their plain versions.

tree_aggregate — weighted child-update reduction, one launch per tree
                 level; f32, bf16 or int8 input (CUDA C++,
                 ``csrc/tree_aggregate.cu``)
quantize       — QSGD int8 quantize and dequantize of (R, 256) rows
                 (CUDA C++, ``csrc/quantize.cu``)
broadcast      — fused dequantize-and-apply of a broadcast delta chain
                 (CUDA C++, ``csrc/broadcast.cu``)
fused_update   — the FedProx client update w - lr (g + mu (w - w0) + wd w),
                 f32 or bf16, every leaf of a local step in one launch
                 (CUDA C++, ``csrc/fused_update.cu``)
policy_update  — Algorithm-1 lines 5-8 for every node, lanes over
                 candidates, line 5 once per mask row
                 (CUDA C++, ``csrc/policy_update.cu``)

``ops.py`` holds the public wrappers, ``ref.py`` the plain PyTorch
versions, ``_build.py`` the nvcc build.  A CPU tensor takes the plain
version; a CUDA tensor takes the kernel or raises.  Nothing is compiled
or loaded at import.
"""
