"""Helpers of the port shared across its layers: the ``.npz`` state
format (framework-free) and numeric modes."""
