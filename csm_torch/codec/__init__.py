"""Mimi neural audio codec (SEANet, transformer, split RVQ)."""
