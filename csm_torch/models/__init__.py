"""The CSM model: configuration, transformer, frame step and frame loop."""
