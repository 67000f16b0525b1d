"""The stencil engine, its plugin, the oracle and the Hopper kernels."""
