"""Rigid-body physics on torch tensors: the model compiler, state and the
fused step gate."""
