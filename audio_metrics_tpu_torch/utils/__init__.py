"""Helpers of the port shared across its layers: the ``.npz`` state
format (framework-free) and numeric modes."""

from .serialize import load_state_dict, save_state_dict

__all__ = ["save_state_dict", "load_state_dict"]
