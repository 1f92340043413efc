"""Prompt assembly: tokenizers and frame packing."""
