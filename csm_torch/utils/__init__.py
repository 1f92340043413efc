"""Parameter trees, device selection and the kernels' build."""
