"""The mini columnar query engine over torch tensors."""
